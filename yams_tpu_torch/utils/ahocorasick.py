"""Aho-Corasick multi-pattern string matching (Simeon retrieval-util parity).

Classic trie + failure-link automaton: match M patterns over a text in one
pass. Used by GrepService for multi-literal queries and by the KG for bulk
alias scanning (where per-pattern find_all would be O(M*N)).

Copied from yams_tpu/utils/ahocorasick.py (the port imports nothing of yams_tpu):
past this docstring the code is the original's, line for line
(tests/test_torch_host_copies.py); its relative imports resolve to
the port's own modules.
"""

from __future__ import annotations

from collections import deque


class AhoCorasick:
    def __init__(self, patterns: list[str], case_insensitive: bool = False):
        self.case_insensitive = case_insensitive
        self.patterns = list(patterns)
        # trie as list-of-dicts; node 0 is root
        self._next: list[dict[str, int]] = [{}]
        self._fail: list[int] = [0]
        self._out: list[list[int]] = [[]]
        for idx, pat in enumerate(self.patterns):
            if case_insensitive:
                pat = pat.lower()
            node = 0
            for ch in pat:
                nxt = self._next[node].get(ch)
                if nxt is None:
                    nxt = len(self._next)
                    self._next.append({})
                    self._fail.append(0)
                    self._out.append([])
                    self._next[node][ch] = nxt
                node = nxt
            self._out[node].append(idx)
        # BFS failure links
        q = deque()
        for ch, child in self._next[0].items():
            q.append(child)
        while q:
            node = q.popleft()
            for ch, child in self._next[node].items():
                q.append(child)
                f = self._fail[node]
                while f and ch not in self._next[f]:
                    f = self._fail[f]
                self._fail[child] = self._next[f].get(ch, 0)
                if self._fail[child] == child:
                    self._fail[child] = 0
                self._out[child] = self._out[child] + self._out[self._fail[child]]

    def finditer(self, text: str):
        """Yield (end_offset_exclusive, pattern_index) for every match."""
        if self.case_insensitive:
            text = text.lower()
        node = 0
        for i, ch in enumerate(text):
            while node and ch not in self._next[node]:
                node = self._fail[node]
            node = self._next[node].get(ch, 0)
            for pat_idx in self._out[node]:
                yield i + 1, pat_idx

    def find_all(self, text: str) -> list[tuple[int, int, int]]:
        """[(start, end, pattern_index)] for every match."""
        out = []
        for end, idx in self.finditer(text):
            plen = len(self.patterns[idx])
            out.append((end - plen, end, idx))
        return out

    def contains_any(self, text: str) -> bool:
        for _ in self.finditer(text):
            return True
        return False
