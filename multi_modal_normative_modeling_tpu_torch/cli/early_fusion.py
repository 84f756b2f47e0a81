"""Offline early-fusion concatenation (counterpart of cli/early_fusion.py).

Drop-in for early_fusion_modalities.py (which is broken as committed — it
imports a symbol utils.py never defined, SURVEY.md section 2.1): concatenates
every base modality CSV per resource, suffixing each feature column with the
modality name, asserting IID alignment, and writing
data/<resource>/early_fusion_modalities_<resource>.csv.
"""
from __future__ import annotations

import argparse
from pathlib import Path

import pandas as pd

from .. import registry


def build_early_fusion(project_root: Path, dataset_resource: str) -> Path:
    dataset_names = registry.get_datasets_name(dataset_resource)
    merged = pd.DataFrame()
    iid = None
    for dataset_name in dataset_names:
        path = (Path(project_root) / "data" / dataset_resource /
                f"{dataset_name}.csv")
        frame = pd.read_csv(path)
        print(f"{dataset_name} shape: {frame.shape}")
        frame.set_index("IID", inplace=True)
        frame = frame.rename(
            columns={c: f"{c}_{dataset_name}" for c in frame.columns}
        )
        if iid is None:
            iid = frame.index
        elif len(iid) != len(frame.index) or not (iid == frame.index).all():
            # an explicit error (asserts vanish under -O, and pd.concat
            # would silently outer-align with NaN fill)
            raise ValueError(
                f"{dataset_name}.csv IID order differs from the first "
                "modality's; every modality CSV must cover the same "
                "subjects in the same order")
        merged = pd.concat([merged, frame], axis=1)
    out = (Path(project_root) / "data" / dataset_resource /
           f"early_fusion_modalities_{dataset_resource}.csv")
    merged.to_csv(out)
    return out


def run(argv=None, project_root=None):
    parser = argparse.ArgumentParser()
    parser.add_argument("-R", "--resources", nargs="+",
                        default=["ADNI", "ADHD", "HCPimage"])
    args = parser.parse_args(argv)
    root = Path(project_root) if project_root else Path.cwd()
    for resource in args.resources:
        build_early_fusion(root, resource)


if __name__ == "__main__":
    run()
