"""Synthetic skeleton segmentation dataset in the on-disk directory format —
the port's own copy of ``stgx/data/synth.py``: the same files for the same
arguments.

Unequal-length trials of per-frame-labelled skeleton motion with learnable
class structure (each action class drives the joints with its own
frequency, phase and gain, plus noise), so a training run can show its loss
fall without real recordings. Writes ``{out}/{train,val}/{features,labels}``
and an ``actions.txt``.

CLI: ``python -m stgx_torch.data.synth --out DIR [--skeleton pku-mmd
--classes 52 --in-feat 3 ...]``
"""

from __future__ import annotations

import argparse
import os

import numpy as np

from stgx_torch.graph import load_skeleton

__all__ = ["generate"]


def generate(
    out_dir: str,
    skeleton: str = "imu_fogit_ABCD",
    num_classes: int = 6,
    in_feat: int = 6,
    num_train: int = 16,
    num_val: int = 6,
    min_len: int = 180,
    max_len: int = 600,
    segments_per_trial: int = 6,
    seed: int = 0,
) -> dict:
    """Write the dataset; returns a summary dict with paths and shapes."""
    rng = np.random.default_rng(seed)
    v = load_skeleton(skeleton)["num_node"]

    # class signatures: per-class frequency, phase, and joint emphasis
    freqs = rng.uniform(0.02, 0.3, size=(num_classes, in_feat))
    gains = rng.uniform(0.5, 2.0, size=(num_classes, v, in_feat))
    offsets = rng.normal(0, 0.5, size=(num_classes, v, in_feat))

    for split, count in (("train", num_train), ("val", num_val)):
        fdir = os.path.join(out_dir, split, "features")
        ldir = os.path.join(out_dir, split, "labels")
        os.makedirs(fdir, exist_ok=True)
        os.makedirs(ldir, exist_ok=True)
        for i in range(count):
            L = int(rng.integers(min_len, max_len + 1))
            # random class segments; class 0 = background appears too
            bounds = np.sort(
                rng.choice(np.arange(1, L), size=segments_per_trial - 1, replace=False)
            )
            bounds = np.concatenate([[0], bounds, [L]])
            labels = np.zeros(L, dtype=np.int32)
            x = np.zeros((L, v, in_feat), dtype=np.float32)
            t = np.arange(L, dtype=np.float32)
            for s in range(segments_per_trial):
                cls = int(rng.integers(0, num_classes))
                sl = slice(bounds[s], bounds[s + 1])
                labels[sl] = cls
                phase = rng.uniform(0, 2 * np.pi)
                sig = np.sin(t[sl, None, None] * freqs[cls][None, None, :] + phase)
                x[sl] = gains[cls][None] * sig + offsets[cls][None]
            x += rng.normal(0, 0.25, size=x.shape).astype(np.float32)

            # store as (C, L, V, M=1), the reference's disk layout
            np.save(
                os.path.join(fdir, f"trial{i:04d}.npy"),
                np.ascontiguousarray(np.transpose(x, (2, 0, 1))[..., None]),
            )
            np.savetxt(os.path.join(ldir, f"trial{i:04d}.csv"), labels, delimiter=",")

    actions_path = os.path.join(out_dir, "actions.txt")
    with open(actions_path, "w") as f:
        f.write("\n".join(["background"] + [f"action{i}" for i in range(1, num_classes)]))

    return {
        "out_dir": out_dir,
        "skeleton": skeleton,
        "num_classes": num_classes,
        "in_feat": in_feat,
        "actions": actions_path,
    }


if __name__ == "__main__":
    p = argparse.ArgumentParser(description=__doc__)
    p.add_argument("--out", required=True)
    p.add_argument("--skeleton", default="imu_fogit_ABCD")
    p.add_argument("--classes", type=int, default=6)
    p.add_argument("--in-feat", type=int, default=6)
    p.add_argument("--train", type=int, default=16)
    p.add_argument("--val", type=int, default=6)
    p.add_argument("--seed", type=int, default=0)
    a = p.parse_args()
    print(generate(a.out, a.skeleton, a.classes, a.in_feat, a.train, a.val,
                   seed=a.seed))
