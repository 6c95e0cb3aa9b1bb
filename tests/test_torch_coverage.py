"""Every file of the reference has its counterpart in the port, or is named.

The earlier check compared the two packages' `.py` lists only, and missed
the mobile C ABI (a `.cpp` and a `.h`) and most of the root `scripts/`.
Here every file under `yams_tpu/` (every type; the `_build/` output and
bytecode skipped), every file of the root `scripts/` and the root
`bench.py` must have a file at the same relative path in `yams_tpu_torch/`
(`scripts/X` -> `yams_tpu_torch/scripts/X`, `bench.py` ->
`yams_tpu_torch/bench.py`), or be named in NOT_PORTED with its reason.
NOT_PORTED must name only files that exist and lack a counterpart, and
must agree with ROADMAP.md's queue 1, which names every one of them.
"""

import pathlib
import re

import pytest

REPO = pathlib.Path(__file__).resolve().parents[1]

NOT_PORTED = {
    # the benchmark and its A/B wait for the port's benchmark cells (ROADMAP item 10)
    "bench.py": "item 10",
    "scripts/bench_ab_r5.py": "item 10",
    # data files the port reads by path (yams_tpu_torch/embed/provider.py)
    "yams_tpu/embed/checkpoints/realtext_bert_d192.npz": "read by path",
    "yams_tpu/embed/checkpoints/synthetic_bert_d128.npz": "read by path",
}


def reference_files() -> list[str]:
    out = []
    for f in sorted((REPO / "yams_tpu").rglob("*")):
        rel = f.relative_to(REPO)
        if f.is_file() and "_build" not in rel.parts and "__pycache__" not in rel.parts \
                and f.suffix != ".pyc":
            out.append(str(rel))
    out += [str(f.relative_to(REPO)) for f in sorted((REPO / "scripts").iterdir())
            if f.is_file() and f.suffix != ".pyc"]
    return out + ["bench.py"]


def counterpart(rel: str) -> pathlib.Path:
    if rel.startswith("yams_tpu/"):
        return REPO / "yams_tpu_torch" / rel[len("yams_tpu/"):]
    return REPO / "yams_tpu_torch" / rel


def group_of(rel: str) -> str:
    parts = rel.split("/")
    return parts[0] if len(parts) < 3 or parts[0] != "yams_tpu" else f"yams_tpu/{parts[1]}"


GROUPS = sorted({group_of(r) for r in reference_files()})


@pytest.mark.parametrize("group", GROUPS)
def test_every_reference_file_has_its_counterpart_or_is_named(group):
    missing = [r for r in reference_files() if group_of(r) == group
               and not counterpart(r).exists() and r not in NOT_PORTED]
    assert not missing, f"no counterpart in yams_tpu_torch/ and not in NOT_PORTED: {missing}"


def test_the_named_files_exist_and_lack_a_counterpart():
    """A stale entry (a file since ported, or gone) fails: the list stays
    the exact gap."""
    files = set(reference_files())
    for rel in NOT_PORTED:
        assert rel in files and not counterpart(rel).exists(), rel


def test_the_named_files_are_roadmap_queue_1():
    """ROADMAP.md's queue 1 names every file of NOT_PORTED, and every root
    script it names as left is in NOT_PORTED; with no "next slice" entry,
    it names no script as left."""
    text = (REPO / "ROADMAP.md").read_text()
    queue = text[text.index("### 1. Modules to port"):text.index("### 2. ")]
    for rel in NOT_PORTED:
        assert f"`{rel}`" in queue or f"`{pathlib.Path(rel).name}`" in queue, rel
    next_slice = {r for r, why in NOT_PORTED.items() if why == "next slice"}
    if "Scripts left" not in queue:
        assert not next_slice
        return
    left = queue[queue.index("Scripts left"):]
    left = left[:left.index("\n\n")]
    named = set(re.findall(r"`(scripts/[\w.]+\.py)`", left))
    assert named == next_slice


def test_the_checkpoints_are_read_by_path():
    """The port's default hf checkpoint is the reference's file, by path."""
    from yams_tpu_torch.embed.provider import DEFAULT_HF_CHECKPOINT

    assert DEFAULT_HF_CHECKPOINT == REPO / "yams_tpu/embed/checkpoints/realtext_bert_d192.npz"
    assert DEFAULT_HF_CHECKPOINT.exists()
