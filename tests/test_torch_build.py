"""The ctypes signatures of the port's kernel library (`_build._SIGNATURES`)
against the C entry points in yams_tpu_torch/csrc/*.cu: the same names, the
same number of arguments, a pointer (c_void_p) where the C argument is a
pointer and an int64 (c_int64) where it is `int64_t`. No card runs here, so
this is what keeps a changed C signature and its binding together."""

import ctypes
import re

from yams_tpu_torch import _build

ENTRY = re.compile(r'extern "C" int (yt_\w+)\(([^)]*)\)')


def _c_entry_points() -> dict:
    found = {}
    for src in sorted(_build._SRC_DIR.glob("*.cu")):
        for name, args in ENTRY.findall(src.read_text()):
            kinds = []
            for arg in args.split(","):
                arg = " ".join(arg.split())
                if "*" in arg:
                    kinds.append(ctypes.c_void_p)
                elif arg.startswith("int64_t "):
                    kinds.append(ctypes.c_int64)
                else:
                    raise AssertionError(f"{src.name}: {name} takes {arg!r}, neither a pointer "
                                         "nor an int64_t")
            assert name not in found, f"{name} defined twice"
            found[name] = tuple(kinds)
    return found


def test_signatures_match_the_c_entry_points():
    c = _c_entry_points()
    assert set(c) == set(_build._SIGNATURES)
    for name, kinds in c.items():
        assert len(kinds) == len(_build._SIGNATURES[name]), name
        assert kinds == tuple(_build._SIGNATURES[name]), name


def test_every_source_with_an_entry_point_is_read():
    c = _c_entry_points()
    assert len(c) == 7 and "yt_sha256_rows" in c and "yt_select_topk" in c
    assert c["yt_sha256_rows"] == (ctypes.c_void_p, ctypes.c_int64, *(ctypes.c_void_p,) * 4,
                                   ctypes.c_int64, ctypes.c_void_p)
    assert c["yt_select_topk"] == (*(ctypes.c_void_p,) * 4, *(ctypes.c_int64,) * 6,
                                   ctypes.c_void_p)
