"""Offline dataset converters to the on-disk trial format — the port of
``stgx/data/prep.py``, numpy only (it imports nothing of the JAX package).

Functional parity with the reference implementation's ``data_prep/prep.py``:

* :func:`prep_pkummd` — PKU-MMD raw txt features/labels → per-trial
  ``(C=3, L, V=25, M=2)`` .npy + framewise label .csv, split train/val by the
  cross-view (or cross-subject) subject list (prep.py:14-48);
* :func:`prep_imu_fogit` — FOG-IT IMU recordings → ``(C, L, V, 1)`` .npy +
  label .csv with a seeded random 70/30 split (prep.py:51-89; this takes an
  explicit seed instead of global ``random`` state, as the JAX package does);
* :func:`permute_dir` — generic in-place relayout helper (prep.py:7-11).

Unlike the reference these never delete their inputs and write to an output
directory (:func:`permute_dir` alone rewrites its files in place, as asked).
The files they write are the JAX package's, byte for byte, and what
:class:`stgx_torch.data.SkeletonDirDataset` reads.

Run: ``python -m stgx_torch.data.prep {pku-mmd,fog-it,permute} ...`` (on the
host; no device).
"""

from __future__ import annotations

import os

import numpy as np

__all__ = ["prep_pkummd", "prep_imu_fogit", "permute_dir"]


def _ensure_dirs(out_dir: str):
    for split in ("train", "val"):
        os.makedirs(os.path.join(out_dir, split, "features"), exist_ok=True)
        os.makedirs(os.path.join(out_dir, split, "labels"), exist_ok=True)


def prep_pkummd(raw_dir: str, out_dir: str, split: str = "cross-view"):
    """Convert raw PKU-MMD: ``raw_dir/{features,labels}/*.txt`` +
    ``raw_dir/{split}.txt`` (line 2 = comma-separated train trial names)."""
    with open(os.path.join(raw_dir, f"{split}.txt")) as f:
        train_names = set(f.readlines()[1].rstrip("\n").split(", "))

    _ensure_dirs(out_dir)
    for fname in sorted(os.listdir(os.path.join(raw_dir, "features"))):
        name = fname.split(".")[0]
        feats = np.loadtxt(os.path.join(raw_dir, "features", fname), dtype=np.float32)
        # raw rows are frames of 2 bodies × 25 joints × 3 coords → (C, L, V, M)
        feats = np.ascontiguousarray(
            np.transpose(feats.reshape(feats.shape[0], 2, 25, 3), (3, 0, 2, 1))
        )
        labels_spans = np.loadtxt(
            os.path.join(raw_dir, "labels", fname), delimiter=",", dtype=np.int32
        ).reshape(-1, 4)
        framewise = np.zeros(feats.shape[1], dtype=np.int32)
        for row in labels_spans:
            framewise[row[1]: row[2]] = row[0]

        part = "train" if name in train_names else "val"
        np.save(os.path.join(out_dir, part, "features", f"{name}.npy"), feats)
        np.savetxt(
            os.path.join(out_dir, part, "labels", f"{name}.csv"),
            framewise,
            delimiter=",",
        )


def prep_imu_fogit(raw_dir: str, out_dir: str, seed: int = 0,
                   val_fraction: float = 0.3):
    """Convert FOG-IT IMU: ``raw_dir/imu/<subj>/<trial>.npy`` (L, C·V or
    (L, C, V)) + ``raw_dir/annotation/<subj>/<trial>_alltypes.npy``."""
    rng = np.random.default_rng(seed)
    trials = []
    for subj in sorted(os.listdir(os.path.join(raw_dir, "annotation"))):
        for f in sorted(os.listdir(os.path.join(raw_dir, "annotation", subj))):
            name = "".join(f.split("_alltypes")).split(".")[0]
            trials.append((subj, name, f))

    order = rng.permutation(len(trials))
    n_val = int(len(trials) * val_fraction)
    val_idx = set(order[:n_val].tolist())

    _ensure_dirs(out_dir)
    for i, (subj, name, label_file) in enumerate(trials):
        data = np.load(os.path.join(raw_dir, "imu", subj, f"{name}.npy")).astype(
            np.float32
        )
        # (L, C, V) → (C, L, V, 1)
        data = np.ascontiguousarray(
            np.transpose(data.reshape((*data.shape, 1)), (1, 0, 2, 3))
        )
        labels = np.load(
            os.path.join(raw_dir, "annotation", subj, label_file)
        ).astype(np.int32)
        part = "val" if i in val_idx else "train"
        np.save(os.path.join(out_dir, part, "features", f"{name}.npy"), data)
        np.savetxt(
            os.path.join(out_dir, part, "labels", f"{name}.csv"),
            labels.reshape(-1),
            delimiter=",",
        )

    with open(os.path.join(out_dir, "split.txt"), "w") as f:
        tr = [trials[i][1] for i in range(len(trials)) if i not in val_idx]
        va = [trials[i][1] for i in range(len(trials)) if i in val_idx]
        f.write("train:" + ", ".join(tr) + "\nval:" + ", ".join(va))


def permute_dir(data_dir: str, perm=(3, 0, 2, 1)):
    """In-place axis relayout of every .npy in a directory."""
    for f in os.listdir(data_dir):
        if not f.endswith(".npy"):
            continue
        path = os.path.join(data_dir, f)
        data = np.transpose(np.load(path).astype(np.float32), perm)
        np.save(path, np.ascontiguousarray(data))


def main(argv=None):
    """``python -m stgx_torch.data.prep {pku-mmd,fog-it,permute} ...`` — the
    script-style entry the reference's data_prep/prep.py is used as."""
    import argparse

    p = argparse.ArgumentParser(prog="stgx_torch.data.prep")
    sub = p.add_subparsers(dest="cmd", required=True)

    pk = sub.add_parser("pku-mmd", help="raw PKU-MMD txt → per-trial npy/csv")
    pk.add_argument("raw_dir")
    pk.add_argument("out_dir")
    pk.add_argument("--split", default="cross-view",
                    choices=("cross-view", "cross-subject"))

    fg = sub.add_parser("fog-it", help="FOG-IT IMU npy → per-trial npy/csv")
    fg.add_argument("raw_dir")
    fg.add_argument("out_dir")
    fg.add_argument("--seed", type=int, default=0)
    fg.add_argument("--val-fraction", type=float, default=0.3)

    pm = sub.add_parser("permute", help="in-place axis relayout of a dir")
    pm.add_argument("data_dir")
    pm.add_argument("--perm", type=int, nargs=4, default=(3, 0, 2, 1))

    a = p.parse_args(argv)
    if a.cmd == "pku-mmd":
        prep_pkummd(a.raw_dir, a.out_dir, split=a.split)
    elif a.cmd == "fog-it":
        prep_imu_fogit(a.raw_dir, a.out_dir, seed=a.seed,
                       val_fraction=a.val_fraction)
    else:
        permute_dir(a.data_dir, perm=tuple(a.perm))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
