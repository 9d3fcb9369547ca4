"""The port's KITTI-STEP preparer against the JAX package's script, on the CPU.

A seeded raw tree (`tools/data_check.py:write_kitti_step_raw`: train
sequences 0 and 3, val sequence 2, 3 frames of 24x40 each; train sequence
1 left out and one frame of sequence 3 without its panoptic map) goes
through `scripts/kitti_step_prepare.py` (it imports nothing of JAX, so it
runs as a script) and through `video_knet_tpu_torch/tools/
kitti_step_prepare.py`, by copy and by `--symlink`, into two output
directories. Both trees must hold the same names, the same bytes and the
same symlink targets, and both commands print the same lines up to the
output path; `KittiStepDVPS` then indexes the prepared tree's frames.
Every comparison is exact.
"""

import contextlib
import importlib.util
import io
import os
import subprocess
import sys

import pytest
import torch

from video_knet_tpu_torch.data.datasets import KittiStepDVPS
from video_knet_tpu_torch.tools import kitti_step_prepare
from video_knet_tpu_torch.tools.data_check import write_kitti_step_raw

torch.set_num_threads(1)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SCRIPT = os.path.join(ROOT, "scripts", "kitti_step_prepare.py")
SEQS = (0, 3, 2)  # train, train, val; train sequence 1 is missing
FRAMES = 3
NO_ANN = ((3, 1),)


@pytest.fixture(scope="module")
def raw(tmp_path_factory):
    root = tmp_path_factory.mktemp("raw")
    images, panoptic = write_kitti_step_raw(str(root), seqs=SEQS, n_frames=FRAMES, hw=(24, 40),
                                            n_things=3, no_ann=NO_ANN)
    return images, panoptic


def _argv(raw, out: str, symlink: bool) -> list:
    return ["--raw-images", raw[0], "--raw-panoptic", raw[1], "--out", out,
            *(["--symlink"] if symlink else [])]


def _tree(out: str) -> dict:
    """{relative path: (symlink target or None, bytes)} of every file."""
    files = {}
    for d, _, names in os.walk(out):
        for name in names:
            path = os.path.join(d, name)
            target = os.readlink(path) if os.path.islink(path) else None
            with open(path, "rb") as f:
                files[os.path.relpath(path, out)] = (target, f.read())
    return files


@pytest.fixture(scope="module", params=[False, True], ids=["copy", "symlink"])
def prepared(request, raw, tmp_path_factory):
    """(the script's tree, the port's tree, the script's printed lines, the
    port's), each output path written as OUT."""
    symlink = request.param
    base = tmp_path_factory.mktemp("symlink" if symlink else "copy")
    want_out, got_out = str(base / "script"), str(base / "port")
    proc = subprocess.run([sys.executable, SCRIPT, *_argv(raw, want_out, symlink)],
                          capture_output=True, text=True, timeout=120, check=True)
    printed = io.StringIO()
    with contextlib.redirect_stdout(printed):
        kitti_step_prepare.main(_argv(raw, got_out, symlink))
    return dict(symlink=symlink, want=_tree(want_out), got=_tree(got_out), root=got_out,
                want_lines=proc.stdout.replace(want_out, "OUT").splitlines(),
                got_lines=printed.getvalue().replace(got_out, "OUT").splitlines())


def test_split_is_the_scripts():
    spec = importlib.util.spec_from_file_location("jax_kitti_step_prepare", SCRIPT)
    script = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(script)
    assert kitti_step_prepare.TRAIN_SEQS == script.TRAIN_SEQS
    assert kitti_step_prepare.VAL_SEQS == script.VAL_SEQS


def test_prepared_tree_is_the_scripts(prepared):
    """The same names, bytes and symlink targets; every frame of the raw tree
    there, and no panoptic map where the raw tree has none."""
    want, got = prepared["want"], prepared["got"]
    assert sorted(got) == sorted(want)
    for name, (target, data) in want.items():
        assert got[name] == (target, data), name
        assert (target is not None) == prepared["symlink"], name
    names = {(s, f, kind) for s in SEQS for f in range(FRAMES) for kind in ("leftImg8bit",
                                                                           "panoptic")
             if (s, f) not in NO_ANN or kind == "leftImg8bit"}
    split = {0: "train", 3: "train", 2: "val"}
    assert set(got) == {os.path.join("video_sequence", split[s], f"{s:06d}_{f:06d}_{kind}.png")
                        for s, f, kind in names}


def test_printed_lines_are_the_scripts(prepared):
    lines = prepared["got_lines"]
    assert lines == prepared["want_lines"]
    skipped = [line for line in lines if line.startswith("skip missing ")]
    assert len(skipped) == 21 - len(SEQS) and any(line.endswith(os.path.join("images", "0001"))
                                                  for line in skipped)
    assert [line for line in lines if not line.startswith("skip missing ")] == [
        f"{split}: done -> " + os.path.join("OUT", "video_sequence", split)
        for split in ("train", "val")]


@pytest.mark.parametrize("split,seqs", [("train", (0, 3)), ("val", (2,))])
def test_dataset_indexes_the_prepared_tree(prepared, split, seqs):
    ds = KittiStepDVPS(prepared["root"], split, ref_seq_index=[-2, -1, 1, 2])
    assert sorted(ds.frames) == [(s, f) for s in sorted(seqs) for f in range(FRAMES)]
    assert len(ds) == len(seqs) * FRAMES
    for (s, f), sample in ds.frames.items():
        assert os.path.exists(sample.img)
        assert (sample.ann is None) == ((s, f) in NO_ANN), (s, f)
