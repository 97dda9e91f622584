"""The port's host tools on the CPU, against the JAX package's.

* ``stgx_torch.data.prep``: ``prep_pkummd`` (cross-view and cross-subject
  lists), ``prep_imu_fogit`` (explicit seed, its 70/30 split) and
  ``permute_dir`` on small raw PKU-MMD and FOG-IT trees written here give
  the JAX package's output files, byte for byte, through the module
  entry point (``main``) too; the raw trees are left as they were.
* ``stgx_torch.utils.visualize``: ``render_all`` over the artifacts of one
  port CLI ``train`` epoch and ``test`` writes the same PNG files as the
  JAX package's ``render_all`` over a copy (skipped only where matplotlib
  is missing).
* ``stgx_torch.native``: the library builds under ``stgx_torch/_build/``,
  never beside its source; ``load_npy_f32`` equals
  ``np.load(...).astype(float32)`` bit for bit for every type
  ``tests/test_native_loader.py`` covers (float32, float64, int32, int64),
  through the native parser; the files it does not take (float16, uint8,
  big-endian, Fortran order) go to ``np.load``, and only those; the
  ``Prefetcher`` hands back every file in order, an unsupported one in the
  middle included; a missing file raises; a build that fails raises with
  ``g++``'s output; the directory dataset reads through the loader.
"""

import filecmp
import json
import os
import shutil

import numpy as np
import pytest

from stgx_torch import native
from stgx_torch.data import prep

RNG = np.random.default_rng(7)


def _tree_files(root):
    return sorted(os.path.relpath(os.path.join(d, f), root)
                  for d, _, fs in os.walk(root) for f in fs)


def _same_trees(a, b):
    files = _tree_files(a)
    assert files == _tree_files(b) and files
    for f in files:
        assert filecmp.cmp(os.path.join(a, f), os.path.join(b, f), shallow=False), f


@pytest.fixture(scope="module")
def raw_pkummd(tmp_path_factory):
    """Five trials of 2 bodies × 25 joints × 3 coordinates a frame, their
    action spans, and the split lists."""
    root = tmp_path_factory.mktemp("pkummd_raw")
    names = [f"{i:04d}-M" for i in range(5)]
    for d in ("features", "labels"):
        os.makedirs(root / d)
    for name in names:
        frames = int(RNG.integers(20, 40))
        np.savetxt(root / "features" / f"{name}.txt", RNG.normal(size=(frames, 150)),
                   fmt="%.6f")
        spans = [(int(RNG.integers(1, 52)), s, s + 6, 1) for s in range(2, frames - 8, 9)]
        with open(root / "labels" / f"{name}.txt", "w") as f:
            f.write("\n".join(",".join(map(str, row)) for row in spans) + "\n")
    for split, train in (("cross-view", names[:3]), ("cross-subject", names[1:4])):
        (root / f"{split}.txt").write_text("Training videos:\n" + ", ".join(train) + "\n")
    return str(root)


@pytest.fixture(scope="module")
def raw_fogit(tmp_path_factory):
    """Seven IMU trials of two subjects, ``(L, C, V)`` and ``(L, C·V)``,
    with their per-frame annotations."""
    root = tmp_path_factory.mktemp("fogit_raw")
    for i in range(7):
        subj = f"S{i % 2}"
        os.makedirs(root / "imu" / subj, exist_ok=True)
        os.makedirs(root / "annotation" / subj, exist_ok=True)
        frames = int(RNG.integers(15, 30))
        np.save(root / "imu" / subj / f"t{i}.npy", RNG.normal(size=(frames, 6, 7)))
        np.save(root / "annotation" / subj / f"t{i}_alltypes.npy",
                RNG.integers(0, 3, size=frames))
    return str(root)


@pytest.mark.parametrize("split", ["cross-view", "cross-subject"])
def test_prep_pkummd_writes_the_jax_files(raw_pkummd, tmp_path, split):
    from stgx.data import prep as j_prep

    before = {f: open(os.path.join(raw_pkummd, f), "rb").read()
              for f in _tree_files(raw_pkummd)}
    assert prep.main(["pku-mmd", raw_pkummd, str(tmp_path / "port"), "--split", split]) == 0
    j_prep.prep_pkummd(raw_pkummd, str(tmp_path / "jax"), split=split)
    _same_trees(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port" / "train" / "features")) == 3
    assert before == {f: open(os.path.join(raw_pkummd, f), "rb").read()
                      for f in _tree_files(raw_pkummd)}


@pytest.mark.parametrize("seed", [0, 3])
def test_prep_fogit_writes_the_jax_files(raw_fogit, tmp_path, seed):
    from stgx.data import prep as j_prep

    prep.prep_imu_fogit(raw_fogit, str(tmp_path / "port"), seed=seed)
    j_prep.prep_imu_fogit(raw_fogit, str(tmp_path / "jax"), seed=seed)
    _same_trees(tmp_path / "port", tmp_path / "jax")
    assert len(os.listdir(tmp_path / "port" / "val" / "features")) == 2  # int(7 * 0.3)
    assert len(_tree_files(raw_fogit)) == 14


def test_permute_dir_rewrites_as_the_jax_one(raw_fogit, tmp_path):
    from stgx.data import prep as j_prep

    for tag, fn in (("port", lambda d: prep.main(["permute", d, "--perm", "1", "0", "2", "3"])),
                    ("jax", lambda d: j_prep.permute_dir(d, (1, 0, 2, 3)))):
        prep.prep_imu_fogit(raw_fogit, str(tmp_path / tag), seed=1)
        fn(str(tmp_path / tag / "train" / "features"))
    _same_trees(tmp_path / "port", tmp_path / "jax")
    x = np.load(next((tmp_path / "port" / "train" / "features").iterdir()))
    assert x.shape[1] == 6 and x.dtype == np.float32  # (L, C, V, 1) again


def test_render_all_writes_the_jax_png_set(tmp_path):
    pytest.importorskip("matplotlib")
    from stgx.utils.visualize import render_all as j_render_all
    from stgx_torch.cli import main
    from stgx_torch.data.synth import generate
    from stgx_torch.utils.visualize import render_all

    data = str(tmp_path / "data")
    generate(data, num_train=2, num_val=2, min_len=40, max_len=60, seed=2)
    out = tmp_path / "out"
    cfg = {
        "processor": {"model": "rt-st-gcn", "data": data, "out": str(out),
                      "actions": os.path.join(data, "actions.txt"), "graph": "imu_fogit_ABCD",
                      "demo": [0, 1], "iou_threshold": [0.5]},
        "arch": {"in_feat": 6, "normalization": "LayerNorm",
                 "rt-st-gcn": {"kernel": 3, "in_ch": [8], "out_ch": [8], "stride": [1],
                               "residual": [1], "dropout": [0], "importance": True}},
        "optimizer": {"seed": 1, "epochs": 1, "checkpoint_indices": [], "learning_rate": 1e-3,
                      "learning_rate_decay": 1.0, "batch_size": 2},
        "job": {"verbose": 0, "platform": "cpu"},
    }
    path = tmp_path / "cfg.json"
    path.write_text(json.dumps(cfg))
    assert main(["train", "--config", str(path)]) == 0
    assert main(["test", "--config", str(path), "--set",
                 f"processor.checkpoint={json.dumps(str(out / 'final'))}"]) == 0
    shutil.copytree(out, tmp_path / "jax")
    got = sorted(os.path.basename(p) for p in render_all(str(out)))
    ref = sorted(os.path.basename(p) for p in j_render_all(str(tmp_path / "jax")))
    assert got == ref
    assert {"train-validation-curve.png", "confusion-matrix.png", "confusion-matrix-0.png",
            "segmentation-0.png", "segmentation-1.png"} <= set(got)
    assert all((out / name).stat().st_size > 0 for name in got)


@pytest.fixture(scope="module")
def npy_files(tmp_path_factory):
    """The native parser's four types, and four files it does not take."""
    d = tmp_path_factory.mktemp("npy")
    rng = np.random.default_rng(0)
    taken, other = [], []
    for i, dtype in enumerate([np.float32, np.float64, np.int32, np.int64]):
        path = str(d / f"arr{i}.npy")
        np.save(path, (rng.normal(size=(3, 5, 7)) * 10).astype(dtype))
        taken.append(path)
    for i, a in enumerate([rng.normal(size=(4, 6)).astype(np.float16),
                           rng.integers(0, 255, size=(2, 9)).astype(np.uint8),
                           rng.normal(size=(3, 4)).astype(">f4"),
                           np.asfortranarray(rng.normal(size=(5, 3)))]):
        path = str(d / f"other{i}.npy")
        np.save(path, a)
        other.append(path)
    return taken, other


@pytest.fixture
def np_loads(monkeypatch):
    """The paths ``np.load`` is called with."""
    calls, load = [], np.load
    monkeypatch.setattr(np, "load", lambda path, *a, **k: calls.append(path) or load(path, *a, **k))
    return calls


def test_library_builds_under_the_build_dir():
    path = native.library_path()
    assert native.available() and path.is_file()
    assert path.parent.parent == native.BUILD_DIR and native.BUILD_DIR.name == "_build"
    assert not any(p.suffix == ".so" for p in native.SOURCE.parent.iterdir())


def test_load_equals_np_load_and_falls_back_for_what_it_does_not_parse(npy_files, np_loads):
    taken, other = npy_files
    for path in taken + other:
        ref = np.load(path).astype(np.float32)
        np_loads.clear()
        got = native.load_npy_f32(path)
        assert got.dtype == np.float32 and got.shape == ref.shape
        np.testing.assert_array_equal(got, ref)
        assert np_loads == ([] if path in taken else [path]), path


def test_prefetcher_order_and_values(npy_files, np_loads):
    taken, other = npy_files
    paths = taken * 2 + [other[0]] + taken
    refs = [np.load(p).astype(np.float32) for p in paths]
    np_loads.clear()
    with native.Prefetcher(paths, ahead=2, threads=3) as pf:
        got = list(pf)
    assert len(got) == len(paths)
    for g, r in zip(got, refs):
        np.testing.assert_array_equal(g, r)
    assert np_loads == [other[0]]  # the one file the parser does not take


def test_missing_file_raises(tmp_path):
    with pytest.raises(FileNotFoundError):
        native.load_npy_f32(str(tmp_path / "nope.npy"))


def test_failed_build_raises_with_the_compiler_output(tmp_path, monkeypatch):
    broken = tmp_path / "npy_loader.cpp"
    broken.write_text(native.SOURCE.read_text() + "\nthis is not C++;\n")
    monkeypatch.setattr(native, "SOURCE", broken)
    monkeypatch.setattr(native, "BUILD_DIR", tmp_path / "build")
    monkeypatch.setattr(native, "_lib", None)
    with pytest.raises(RuntimeError, match="g\\+\\+ failed") as e:
        native.native_lib()
    assert "error" in str(e.value) and "this is not C++" in str(e.value)
    assert not list((tmp_path / "build").rglob("*.so"))


def test_dir_dataset_reads_through_the_native_loader(tmp_path, np_loads):
    from stgx_torch.data import SkeletonDirDataset
    from stgx_torch.data.synth import generate

    generate(str(tmp_path), num_train=2, num_val=1, min_len=20, max_len=30, seed=5)
    ds = SkeletonDirDataset(str(tmp_path / "train" / "features"),
                            str(tmp_path / "train" / "labels"))
    np_loads.clear()
    x, y = ds[0]
    assert np_loads == []
    raw = np.load(tmp_path / "train" / "features" / f"{ds.names[0]}.npy")
    np.testing.assert_array_equal(x, np.transpose(raw[..., 0], (1, 2, 0)).astype(np.float32))
    assert x.dtype == np.float32 and len(y) == x.shape[0]
