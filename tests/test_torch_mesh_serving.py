"""The grids, the scoring service and the doctor on a mesh of ranks, on the
CPU: two ranks (torch.multiprocessing spawn, gloo over a file store)
against the port's unmeshed runs.

One spawn runs, each rank the same calls:

  * ``sweep_supervised`` with --mesh 2,1 and with --ep_mesh 1,2,1 (two
    epoch milestones of one ADHD point), and ``sweep_endtoend`` with --mesh
    2,1 (two margins, the 'config' axis over the ranks);
  * ``sweep_classifiers`` on a ('config',) mesh of two;
  * ``ScoringService`` with --mesh 1,2 and with --ep_mesh 1,2,1 on a
    trained ADNI UCA-gPoE project: rank 0 scores requests of 1 and 70
    subjects (ROI, latent under --mesh) while rank 1 loops in
    ``serve_worker``, until rank 0 sends shutdown.

The bounds are the JAX tests' (checkpoints rtol 2e-4 / atol 2e-5, CSVs and
scores rtol 1e-5 / atol 1e-7). The doctor's --mesh-check and --ep-check
start their own child torchrun of CPU ranks."""
import json
import shutil
from pathlib import Path

import numpy as np
import pandas as pd
import pytest
import torch
import torch.multiprocessing as mp

from multi_modal_normative_modeling_tpu_torch.cli import (
    doctor,
    serve,
    sweep_endtoend,
    sweep_supervised,
    train_supervised,
)
from multi_modal_normative_modeling_tpu_torch.cli import common
from multi_modal_normative_modeling_tpu_torch.data.synthetic import (
    make_synthetic_resource,
)
from multi_modal_normative_modeling_tpu_torch.models import classifier
from multi_modal_normative_modeling_tpu_torch.parallel import distributed
from tests.test_torch_mesh_cli import (
    _leaves,
    _params,
    join_world,
    rendezvous,
)
from tests.test_torch_threads import one_torch_thread  # noqa: F401

TRAIN_TOL = dict(rtol=2e-4, atol=2e-5)
CSV_TOL = dict(rtol=1e-5, atol=1e-7)
SWEEP = ["-R", "ADHD", "-K", "2", "--procedures", "SE-gPoE", "--hz_grid",
         "12 12 4", "--epochs_list", "2", "3", "--device", "cpu"]
SWEEPS = {"sweep_mesh": ["--mesh", "2,1"], "sweep_ep": ["--ep_mesh", "1,2,1"]}
E2E = ["-R", "ADNI", "-P", "SE-MoE", "-K", "2", "-H", "12", "12", "4",
       "-Layers", "16", "8", "-Margins", "0.5", "1", "-Weightcontrastives",
       "0.1", "-E", "2", "--device", "cpu"]
GRID = [{"initial_lr": lr, "factor": 0.5, "patience": 2, "min_lr": 1e-6,
         "dropout": d} for lr in (1e-3, 1e-2) for d in (0.1, 0.3)]
SERVE_MESHES = {"serve_mesh": ("mesh", "1,2"),
                "serve_ep": ("ep_mesh", "1,2,1")}


def _classifier_grid(mesh=None):
    rng = np.random.default_rng(0)
    x = rng.normal(size=(40, 6)).astype(np.float32)
    y = (x[:, 0] > 0).astype(np.int64)
    model = classifier.MLPClassifier(6, [8], dropout=0.2,
                                     generator=torch.Generator()
                                     .manual_seed(0))
    best, hist = classifier.sweep_classifiers(model, x[:30], y[:30], x[30:],
                                              y[30:], 5, GRID, mesh=mesh)
    return ({n: p.detach().numpy() for n, p in best.named_parameters()},
            hist)


def _requests(service, latent: bool):
    ids = pd.read_csv(service.project_root / "data" / "ADNI" / "y.csv")
    ids = ids["IID"].tolist()
    out = [service.score_ids(ids[:1], roi=True),
           service.score_ids(ids[:70], roi=True)]
    if latent:
        out.append(service.score_ids(ids[:5], latent=True))
    else:
        with pytest.raises(serve.ServeError, match="not available under "
                                                   "--ep_mesh"):
            service.score_ids(ids[:5], latent=True)
    return out, service.health()


def _ranks(rank, world, store, base):
    join_world(rank, world, store)
    base = Path(base)
    # the CLIs' mains: their run() leaves the process group at the end
    for name, flags in SWEEPS.items():
        sweep_supervised.main(sweep_supervised.build_parser().parse_args(
            SWEEP + flags), project_root=base / name)
    args = sweep_endtoend.build_parser().parse_args(E2E + ["--mesh", "2,1"])
    common.apply_post_parse_defaults(args, default_procedure="SE-MoE")
    sweep_endtoend.main(args, project_root=base / "e2e_mesh")
    from multi_modal_normative_modeling_tpu_torch.parallel.mesh import (
        build_mesh,
    )

    grid = _classifier_grid(build_mesh({"config": 2}))
    for name, (kind, spec) in SERVE_MESHES.items():
        kwargs = {"mesh": common.parse_infer_mesh(spec)} if kind == "mesh" \
            else {"ep_mesh": common.parse_ep_mesh(spec, (3,), "x")[0]}
        service = serve.ScoringService(
            "ADNI", "UCA-gPoE", n_splits=2, project_root=base / "served",
            device="cpu", **kwargs)
        if rank:
            service.serve_worker()
            continue
        out, health = _requests(service, latent=kind == "mesh")
        service.shutdown_workers()
        (base / f"{name}.json").write_text(json.dumps({"out": out,
                                                       "health": health}))
    if rank == 0:
        np.save(base / "grid.npy", np.asarray([grid], dtype=object),
                allow_pickle=True)
    distributed.shutdown()


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    base = tmp_path_factory.mktemp("mesh_serving")
    for name in ["sweep_plain", *SWEEPS]:
        make_synthetic_resource(base / name, "ADHD", n_hc=30,
                                n_disease={0: 10, 2: 10})
    for name in ("e2e_plain", "e2e_mesh"):
        make_synthetic_resource(base / name, "ADNI", n_hc=30,
                                n_disease={0: 10, 1: 10}, with_fi=True)
    make_synthetic_resource(base / "served", "ADNI", n_hc=30,
                            n_disease={0: 10, 1: 10},
                            with_early_fusion=True)
    train_supervised.run(["-R", "ADNI", "-P", "UCA-gPoE", "-E", "2", "-K",
                          "2", "-H", "12", "12", "4", "--device", "cpu"],
                         project_root=base / "served")
    sweep_supervised.run(SWEEP, project_root=base / "sweep_plain")
    sweep_endtoend.run(E2E, project_root=base / "e2e_plain")
    mp.spawn(_ranks, args=(2, rendezvous(base), str(base)), nprocs=2)
    return base


@pytest.mark.parametrize("name", sorted(SWEEPS))
def test_meshed_supervised_grid_matches_unmeshed(runs, name):
    """The records' AUCs and the last milestone's checkpoints and CSVs."""
    def records(root):
        return json.loads((root / "outputs"
                           / "sweep_supervised_results.json").read_text())

    got, want = records(runs / name), records(runs / "sweep_plain")
    assert [(r["epochs"], r["hz_para_list"]) for r in got] == [
        (r["epochs"], r["hz_para_list"]) for r in want]
    for g, w in zip(got, want):
        np.testing.assert_allclose(g["stats"]["auc"], w["stats"]["auc"],
                                   **CSV_TOL)
    reference = runs / "sweep_plain"
    if name == "sweep_ep":
        # the expert-parallel grid trains the packed layout
        reference = runs / "sweep_ep_reference"
        if not reference.exists():
            shutil.copytree(runs / "sweep_plain" / "data",
                            reference / "data")
            sweep_supervised.run(SWEEP + ["--packed_xla"],
                                 project_root=reference)
    for fold in (0, 1):
        want_p = dict(_leaves(_params(reference, fold)))
        got_p = dict(_leaves(_params(runs / name, fold)))
        for path in want_p:
            np.testing.assert_allclose(got_p[path], want_p[path],
                                       err_msg=f"{fold} {path}", **TRAIN_TOL)


def test_meshed_endtoend_grid_matches_unmeshed(runs):
    """results_endtoend.csv line by line; the header's Namespace differs
    only in the --mesh it names."""
    got = (runs / "e2e_mesh" / "results_endtoend.csv").read_text()
    want = (runs / "e2e_plain" / "results_endtoend.csv").read_text()
    assert got.replace("mesh='2,1'", "mesh=None") == want


def test_classifier_grid_on_a_config_mesh_matches_unmeshed(runs):
    got_params, got_hist = np.load(runs / "grid.npy",
                                   allow_pickle=True)[0]
    want_params, want_hist = _classifier_grid()
    for n in want_params:
        np.testing.assert_array_equal(got_params[n], want_params[n])
    for g, w in zip(got_hist, want_hist):
        for k in w:
            np.testing.assert_array_equal(g[k], w[k])


@pytest.mark.parametrize("name", sorted(SERVE_MESHES))
def test_meshed_service_matches_unmeshed(runs, name):
    kind, spec = SERVE_MESHES[name]
    result = json.loads((runs / f"{name}.json").read_text())
    service = serve.ScoringService("ADNI", "UCA-gPoE", n_splits=2,
                                   project_root=runs / "served",
                                   device="cpu")
    want, _ = _requests(service, latent=kind == "mesh") \
        if kind == "mesh" else (None, None)
    if want is None:
        want = [service.score_ids(r["participant_id"], roi=True)
                for r in result["out"]]
    assert len(result["out"]) == len(want)
    for got, ref in zip(result["out"], want):
        assert got["participant_id"] == ref["participant_id"]
        for key in ("deviation", "roi", "latent_deviation",
                    "latent_per_dim"):
            if key in ref:
                np.testing.assert_allclose(np.asarray(got[key]),
                                           np.asarray(ref[key]),
                                           err_msg=key, **CSV_TOL)
        for m, values in ref["per_modality"].items():
            np.testing.assert_allclose(got["per_modality"][m], values,
                                       **CSV_TOL)
    health = result["health"]
    sizes = [int(s) for s in spec.split(",")]
    axes = ["fold", "data"] if kind == "mesh" else ["fold", "modality",
                                                    "data"]
    assert health["mesh"] == dict(zip(axes, sizes))
    assert health["ep_layout"] == (None if kind == "mesh"
                                   else "width-grouped")
    assert health["latent_scoring"] == (kind == "mesh")


@pytest.mark.parametrize("argv,section,words", [
    (["--mesh-check", "1,2", "--mesh-folds", "2", "--mesh-batch", "8"],
     "mesh-check", "ran one fold-parallel train step on 2 CPU gloo ranks"),
    (["--ep-check", "2,1", "--mesh-folds", "2", "--mesh-batch", "8"],
     "ep-check", "ran one expert-parallel train epoch on 2 CPU gloo ranks "
                 "(4 modalities"),
    (["--ep-check", "1,2,1", "--ep-dual-bank", "--ep-modalities", "2",
      "--mesh-folds", "2", "--mesh-batch", "8"],
     "ep-check", "(4 dual-bank experts (2M)")])
def test_doctor_preflights_run_their_child_step(argv, section, words,
                                                capsys):
    doctor.run(argv + ["--json"])
    found = [r for r in json.loads(capsys.readouterr().out)
             if r["section"] == section]
    assert len(found) == 1 and found[0]["status"] == "OK", found
    assert words in found[0]["detail"]


def test_doctor_ep_check_refuses_the_dual_bank_m_d_form(capsys):
    doctor.run(["--ep-check", "2,1", "--ep-dual-bank", "--json"])
    found = [r for r in json.loads(capsys.readouterr().out)
             if r["section"] == "ep-check"]
    assert found == [{"section": "ep-check", "status": "FAIL",
                      "detail": "ep mesh 2,1: the packed dual-bank endtoend "
                                "trainer takes the 3-axis F,M,D form "
                                "(nmpmcont --ep_mesh)"}]
