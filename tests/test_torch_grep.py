"""The port's grep against the reference's, on the CPU.

- `utils.ahocorasick.AhoCorasick` gives the reference's matches on seeded
  patterns and texts, case-sensitive and not.
- `native.find_all` gives the reference's offsets (and str.find's, the
  Python route's) on seeded haystacks, overlapping hits included.
- `GrepService.grep` (literal, regex, case-folded, word-bounded, with
  context, path globs, tags, filters, a match cap and the semantic tier)
  and `grep_multi` return the reference's matches on one seeded tree added
  to both packages' AppContext, with the native library and with the
  Python route that runs when it is missing.
"""

import dataclasses

import numpy as np
import pytest

from test_torch_services import make_tree, populate, port_config_for, ref_config_for
from yams_tpu import native as ref_native
from yams_tpu.services.app import AppContext as RefApp
from yams_tpu.utils.ahocorasick import AhoCorasick as RefAC
from yams_tpu_torch import native
from yams_tpu_torch.services.app import AppContext
from yams_tpu_torch.utils.ahocorasick import AhoCorasick

ALPHABET = list("abcAB \n_-")


def _text(rng, n):
    return "".join(rng.choice(ALPHABET, n))


@pytest.mark.parametrize("ignore_case", [False, True])
def test_aho_corasick_matches_the_reference(ignore_case):
    rng = np.random.default_rng(0)
    for _ in range(40):
        pats = list(dict.fromkeys(_text(rng, int(rng.integers(1, 5))) for _ in range(6)))
        text = _text(rng, 400)
        got = AhoCorasick(pats, case_insensitive=ignore_case).find_all(text)
        want = RefAC(pats, case_insensitive=ignore_case).find_all(text)
        assert got == want
    assert AhoCorasick(["he", "she", "hers"]).find_all("ushers") == \
        RefAC(["he", "she", "hers"]).find_all("ushers") != []


def test_find_all_matches_the_reference_and_str_find():
    rng = np.random.default_rng(1)
    assert native.sketch_library() is not None
    for _ in range(50):
        hay = _text(rng, int(rng.integers(0, 600))).encode()
        needle = _text(rng, int(rng.integers(1, 4))).encode()
        got = native.find_all(hay, needle)
        offs, start = [], 0
        while (i := hay.find(needle, start)) >= 0:
            offs.append(i)
            start = i + 1
        assert got == ref_native.find_all(hay, needle) == offs
    assert native.find_all(b"aaaa", b"aa") == [0, 1, 2]
    assert native.find_all(b"abc", b"") == [] and native.find_all(b"ab", b"abc") == []


@pytest.fixture(scope="module")
def apps(tmp_path_factory):
    tree = make_tree(tmp_path_factory.mktemp("tree"), n_notes=60)
    root = tmp_path_factory.mktemp("apps")
    port = AppContext(port_config_for(root / "port"), device="cpu")
    ref = RefApp(ref_config_for(root / "ref"))
    for app in (port, ref):
        populate(app, tree)
    yield port, ref
    port.close()
    ref.close()


GREPS = [
    ("literal", ("w3",), {}),
    ("literal_ci", ("NOTE",), {"ignore_case": True}),
    ("forced_literal", ("w1.",), {"literal": True}),
    ("regex", (r"w1\d+ w[2-4]",), {}),
    ("regex_ci", (r"NOTE \d+",), {"ignore_case": True}),
    ("word", ("w5",), {"word_boundary": True}),
    ("context", ("raft",), {"context": 2}),
    ("path_glob", ("w7",), {"path_glob": "*/d3/*"}),
    ("globs", ("def",), {"path_glob": ["*/src/mod1.py", "*/src/mod2.py"]}),
    ("tags", ("consensus",), {"tags": ["raft"]}),
    ("filters", ("snapshot",), {"filters": {"collection": "logs"}}),
    ("capped", ("w",), {"max_matches": 7}),
    ("semantic", ("compaction",), {"semantic_limit": 3}),
    ("nothing", ("zzzz_absent",), {}),
]


def _rows(res):
    return ([dataclasses.astuple(m) for m in res.matches],
            res.files_searched, res.files_matched, res.truncated)


@pytest.mark.parametrize("python_route", [False, True], ids=["native", "python"])
@pytest.mark.parametrize("name,args,kw", GREPS, ids=[g[0] for g in GREPS])
def test_grep_matches_the_reference(apps, monkeypatch, name, args, kw, python_route):
    port, ref = apps
    if python_route:       # as where the native library is missing
        monkeypatch.setattr(native, "find_all", lambda *a, **k: None)
    got, want = _rows(port.grep.grep(*args, **kw)), _rows(ref.grep.grep(*args, **kw))
    assert got == want
    if name != "nothing":
        assert got[0], name


@pytest.mark.parametrize("patterns,kw", [
    (["w3", "w17", "raft"], {}), (["NOTE", "Raft"], {"ignore_case": True}),
    (["def", "class"], {"path_glob": "*/src/*"}), (["w2", "w4"], {"max_matches": 5}),
    (["consensus"], {"tags": ["ops"]})])
def test_grep_multi_matches_the_reference(apps, patterns, kw):
    port, ref = apps
    got = _rows(port.grep.grep_multi(patterns, **kw))
    assert got == _rows(ref.grep.grep_multi(patterns, **kw)) and got[0]
