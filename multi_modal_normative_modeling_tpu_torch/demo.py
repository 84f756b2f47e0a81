"""Self-contained demo projects for the side notebooks (counterpart of
demo.py): a synthetic ADNI cohort (``data/synthetic.py``, an injected
disease effect so the figures carry signal) through the port's supervised
chain, train -> test -> group analysis, once, so that the notebooks'
figures and tables have real pipeline artifacts to read.

Every stage runs on ``device``, the card by default: the test stages score
through the encoder and decode+deviation kernels, and ``cohort_latents``
encodes the cohort through the encoder kernel. Without a CUDA device the
demo exits, as the CLIs do (``cli/common.resolve_device``); pass
``device="cpu"`` for the kernels' plain versions. Unlike the JAX demo,
nothing pins the CPU.

``init_fn`` and ``eps_fn`` pass through to the train stage
(``cli/train_supervised.main``: the initial weights, the training noise)
and ``score_eps_fn`` to the test stage (``cli/test_supervised.main``'s
``eps_fn``: the scoring noise), so the tests can replay the JAX package's
init and draws.

    from multi_modal_normative_modeling_tpu_torch import demo
    root = demo.ensure_demo_project('outputs/notebook_demo')
    model, params, config = demo.load_fold_model(root)
    latents, labels = demo.cohort_latents(root, model, params)
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def _args(epochs: int, n_splits: int, procedure: str,
          device: str) -> argparse.Namespace:
    suffix = procedure.split("-")[1]
    single = procedure.startswith("SM-")
    return argparse.Namespace(
        dataset_resourse="ADNI", hz_para_list=[32, 32, 8],
        procedure=procedure,
        # SM-<modality>'s suffix is a MODALITY name, not a fusion
        combine="gPoE" if single else suffix,
        epochs=epochs, n_splits=n_splits, oversample_percentage=1,
        model="cVAE_multimodal", single_modality=None,
        base_learning_rate=0.0001, max_learning_rate=0.005,
        training_class="nm", lr_schedule="constant",
        # UCA appends the early-fusion concat modality; build it in memory
        in_memory_fusion=procedure.startswith("UCA"),
        device=device,
    )


def ensure_demo_project(root="outputs/notebook_demo", epochs: int = 60,
                        n_splits: int = 3, procedure: str = "SE-gPoE",
                        force: bool = False, device: str = "cuda",
                        init_fn=None, eps_fn=None,
                        score_eps_fn=None) -> Path:
    """Create (once) a synthetic ADNI project with completed train, test and
    analysis artifacts; returns the project root. A stage whose artifacts
    are there is not run again (``force`` reruns every stage)."""
    from .cli import group_analysis, test_supervised, train_supervised
    from .cli.common import resolve_device
    from .data.synthetic import make_synthetic_resource

    resolve_device(device, "build the demo project")
    root = Path(root)
    args = _args(epochs, n_splits, procedure, device)
    if force or not (root / "data" / "ADNI" / "y.csv").exists():
        root.mkdir(parents=True, exist_ok=True)
        make_synthetic_resource(root, "ADNI", n_hc=90,
                                n_disease={0: 40, 1: 40}, effect=0.8)
    model_dir = root / "outputs" / "kfold_analysis" / "supervised_cvae"
    if force or not (model_dir / "000" / "cVAE_model.ckpt").exists():
        train_supervised.main(args, project_root=root, init_fn=init_fn,
                              eps_fn=eps_fn)
    dev_dir = (root / "deviation" / "supervised_cvae" / "ADNI" / procedure /
               "path_model")
    if force or not dev_dir.exists():
        test_supervised.main(args, project_root=root, eps_fn=score_eps_fn)
    if force or not (root / "result_baseline" / "result_multimodal.txt"
                     ).exists():
        group_analysis.main(args, project_root=root)
    return root


def ensure_procedure_projects(base_root="outputs/notebook_demo_procedures",
                              procedures=("SM-av45", "SE-gPoE", "UCA-gPoE"),
                              epochs: int = 60, n_splits: int = 3,
                              device: str = "cuda", init_fn=None,
                              eps_fn=None, score_eps_fn=None) -> dict:
    """One demo project per procedure (SM single modality, SE simple
    fusion, UCA early-fusion augmented: the reference's procedure grammar,
    utils.py:731-755), each trained on the same synthetic cohort; for the
    per-procedure latent t-SNE panels (tsne.ipynb) and the procedure
    comparison tables (table_visualization.ipynb)."""
    base = Path(base_root)
    return {proc: ensure_demo_project(base / proc.replace("-", "_"),
                                      epochs=epochs, n_splits=n_splits,
                                      procedure=proc, device=device,
                                      init_fn=init_fn, eps_fn=eps_fn,
                                      score_eps_fn=score_eps_fn)
            for proc in procedures}


def load_fold_model(project_root, fold: int = 0, device: str = "cuda"):
    """(model, params, config) of a demo project's fold checkpoint, as
    ``cli/common.load_model_and_params([fold_dir], device)`` gives them: a
    one-fold model on ``device``, its JAX-layout tree with a fold axis of
    1, the checkpoint's config."""
    from .cli.common import load_model_and_params, resolve_device

    fold_dir = (Path(project_root) / "outputs" / "kfold_analysis" /
                "supervised_cvae" / f"{fold:03d}")
    return load_model_and_params([fold_dir],
                                 resolve_device(device, "load the model"))


def cohort_inputs(project_root, procedure: str = None):
    """The whole cohort as ``cohort_latents`` encodes it: (features [N, D_m]
    per modality, scaled on the whole cohort, covariates [N, C] per
    modality, diagnosis labels [N]), numpy, in y.csv's subject order. With
    ``procedure`` the modalities follow the procedure grammar
    (``registry.get_datasets_name``); the UCA early-fusion modality is built
    in memory from the scaled base blocks (numerically the file-based path,
    ``cli/common.fuse_preps``)."""
    import pandas as pd

    from . import registry
    from .data.preprocess import fit_robust_scaler, one_hot_covariates

    project_root = Path(project_root)
    y = pd.read_csv(project_root / "data" / "ADNI" / "y.csv")
    if procedure is None:
        names = list(registry.BASE_MODALITIES["ADNI"])
        fuse_tail = False
    else:
        names = list(registry.get_datasets_name("ADNI", procedure))
        fuse_tail = procedure.startswith("UCA")
        if fuse_tail:
            names = names[:-1]  # early-fusion block built from the bases
    # one shared subject order: reindex every modality against y's IIDs so
    # rows align across modalities regardless of per-CSV ordering
    iids = y["IID"]
    xes, cs = [], []
    for name in names:
        frame = pd.read_csv(project_root / "data" / "ADNI" / f"{name}.csv"
                            ).set_index("IID").loc[iids]
        merged = frame.join(y.set_index("IID"))
        cols = registry.get_column_name("ADNI", name)
        xes.append(fit_robust_scaler(
            merged[cols].values)[0].astype(np.float32))
        cs.append(one_hot_covariates(merged[["DIA", "PTGENDER", "AGE"]]))
    if fuse_tail:
        xes.append(np.concatenate(xes, axis=1))
        cs.append(cs[-1])
    return xes, cs, y["DIA"].values


def cohort_latents(project_root, model, params=None, combine: str = "gpoe",
                   procedure: str = None):
    """Fused latent means for the whole cohort (``cohort_inputs``) and the
    diagnosis labels, for the latent t-SNE (tsne.ipynb).

    ``params`` (a JAX-layout tree, one fold's or fold-stacked, as
    ``load_fold_model`` returns it) is loaded into ``model`` first; None
    uses the model's own weights. The cohort is encoded through the encoder
    kernel, one launch per modality over every fold (its plain version on
    the CPU). Returns (latent means, [N, Z] for a one-fold model and [F, N,
    Z] for a fold-stacked one, as numpy; labels [N])."""
    import torch

    from .interop import params_from_jax

    if params is not None:
        params_from_jax(params, model)
    first = next(model.parameters())
    folds, device = first.shape[0], first.device
    xes, cs, labels = cohort_inputs(project_root, procedure)

    def every_fold(a):
        return torch.from_numpy(a).to(device)[None].expand(
            folds, *a.shape).contiguous()

    mus, _ = model.latent_stats_fused([every_fold(x) for x in xes],
                                      [every_fold(c) for c in cs], combine)
    mus = mus.cpu().numpy()
    return (mus[0] if folds == 1 else mus), labels
