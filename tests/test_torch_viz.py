"""The figures of the port's viz.py against the JAX package's, on the CPU.

Each figure function draws from the same seeded data in both packages: the
t-SNE embedding must be JAX's exactly, and every PNG pixel-equal to JAX's
(``matplotlib.image.imread``). Where matplotlib (or, for the t-SNE,
scikit-learn) is absent, as on the machine with the GPU, each raises
``ModuleNotFoundError`` naming the package; that is checked in a fresh
process with the package's ``sys.modules`` entry set to None.
"""
import subprocess
import sys

import numpy as np
import pandas as pd
import pytest
from matplotlib.image import imread

from multi_modal_normative_modeling_tpu import viz as jax_viz
from multi_modal_normative_modeling_tpu_torch import viz

ROOT = __import__("pathlib").Path(__file__).resolve().parent.parent


def _same_image(a, b):
    got, want = imread(a), imread(b)
    assert got.shape == want.shape
    assert np.array_equal(got, want)


def _roi_csv(path, seed=0):
    """A reconstruction_error_roi_*.csv as the test stage writes it: 60
    subjects (DIA 2 the controls), 20 ROIs, the patients shifted."""
    rng = np.random.default_rng(seed)
    rois = [f"ROI_{i}" for i in range(20)]
    dia = np.repeat([2, 0, 1], 20)
    values = rng.standard_normal((60, 20)) + (dia != 2)[:, None] * np.linspace(
        -1, 1, 20)
    frame = pd.DataFrame(values, columns=rois)
    frame.insert(0, "participant_id", [f"S{i}" for i in range(60)])
    frame.insert(1, "DIA", dia)
    frame.insert(2, "AGE", rng.uniform(60, 90, 60))
    frame.insert(3, "PTGENDER", rng.integers(1, 3, 60))
    frame.to_csv(path, index=False)
    return path


def test_tsne_latents_matches_jax(tmp_path):
    rng = np.random.default_rng(1)
    latents = rng.standard_normal((45, 8)).astype(np.float32)
    labels = np.repeat([0, 1, 2], 15)
    ref = jax_viz.tsne_latents(latents, labels, tmp_path / "jax.png")
    got = viz.tsne_latents(latents, labels, tmp_path / "port.png")
    assert got.shape == (45, 2)
    assert np.array_equal(got, ref)
    _same_image(tmp_path / "port.png", tmp_path / "jax.png")


def test_roi_deviation_map_matches_jax(tmp_path):
    csv = _roi_csv(tmp_path / "roi.csv")
    jax_viz.roi_deviation_map(csv, 2, tmp_path / "jax.png", top_k=12)
    viz.roi_deviation_map(csv, 2, tmp_path / "port.png", top_k=12)
    _same_image(tmp_path / "port.png", tmp_path / "jax.png")


@pytest.mark.parametrize("title", ["", "patients vs controls"])
def test_glass_brain_scatter_matches_jax(tmp_path, title):
    rng = np.random.default_rng(2)
    labels = sorted(viz.aal90_centroids())
    values = dict(zip(labels[::3], rng.standard_normal(len(labels[::3]))))
    values["not_a_region"] = 5.0
    jax_viz.glass_brain_scatter(values, tmp_path / "jax.png", title=title)
    viz.glass_brain_scatter(values, tmp_path / "port.png", title=title)
    _same_image(tmp_path / "port.png", tmp_path / "jax.png")


def test_glass_brain_scatter_refuses_unknown_labels_as_jax(tmp_path):
    values = {"ROI_0": 1.0, "ROI_1": -1.0}
    with pytest.raises(ValueError) as ref:
        jax_viz.glass_brain_scatter(values, tmp_path / "jax.png")
    with pytest.raises(ValueError) as got:
        viz.glass_brain_scatter(values, tmp_path / "port.png")
    assert str(got.value) == str(ref.value)
    assert not list(tmp_path.glob("*.png"))


_ABSENT = """
import sys
sys.path.insert(0, sys.argv[1])
sys.modules[sys.argv[2]] = None
import numpy as np
from multi_modal_normative_modeling_tpu_torch import viz
calls = {
    'tsne_latents': lambda: viz.tsne_latents(
        np.zeros((9, 2)), np.zeros(9), 'x.png'),
    'roi_deviation_map': lambda: viz.roi_deviation_map('x.csv', 2, 'x.png'),
    'glass_brain_scatter': lambda: viz.glass_brain_scatter(
        {'Hippocampus_L': 1.0}, 'x.png'),
}
try:
    calls[sys.argv[3]]()
except ModuleNotFoundError as e:
    print('RAISED', e.name, '|', e)
"""


@pytest.mark.parametrize("function,package", [
    ("tsne_latents", "matplotlib"), ("tsne_latents", "sklearn"),
    ("roi_deviation_map", "matplotlib"),
    ("glass_brain_scatter", "matplotlib")])
def test_a_figure_raises_where_its_package_is_absent(tmp_path, function,
                                                     package):
    out = subprocess.run(
        [sys.executable, "-c", _ABSENT, str(ROOT), package, function],
        capture_output=True, text=True, timeout=120, cwd=tmp_path)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.startswith(f"RAISED {package} |"), out.stdout
    assert f"{function} needs {package}" in out.stdout
    assert not list(tmp_path.glob("*.png"))
