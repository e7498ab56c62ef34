"""Callback Trie Tree (CTT) — paper §4.2.

The CTT is a trie over metapath strings whose level-1 nodes are vertex
types; every node representing a materialized metapath carries a callback
edge pointing back to the level-1 node of its last vertex type.  Walking
the trie with the hardware Matcher semantics (§4.2.2) decomposes a
candidate metapath into a chain of previously-materialized segments that
overlap by exactly one vertex type.  A copy of the JAX package's
``repro.core.ctt``.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, Iterable, List, Optional


@dataclasses.dataclass
class _Node:
    """One CTT node; ``terminal`` marks a materialized metapath."""

    vtype: str
    depth: int
    children: Dict[str, "_Node"] = dataclasses.field(default_factory=dict)
    terminal: bool = False
    callback: Optional["_Node"] = None


class CallbackTrieTree:
    """CTT: init with one-hop metapaths, decompose via the Matcher walk.

    The pointer descends while the next candidate character has a child;
    when it cannot, the longest terminal node passed is emitted as a
    segment and the callback edge returns the pointer to level 1 at the
    segment's last vertex type, so segments overlap by one vertex type.
    """

    def __init__(self, one_hop: Iterable[str]):
        self.root = _Node("", 0)
        self._size = 0
        for rel in sorted(set(one_hop)):
            if len(rel) != 2:
                raise ValueError(f"one-hop metapath must have 2 types, got {rel!r}")
            self.insert(rel)

    def _level1(self, vtype: str) -> _Node:
        node = self.root.children.get(vtype)
        if node is None:
            node = _Node(vtype, 1)
            node.callback = node
            self.root.children[vtype] = node
        return node

    def insert(self, metapath: str) -> None:
        """Store a materialized metapath (the CTT buffer write of §4.2.2)."""
        if len(metapath) < 2:
            raise ValueError("metapath needs at least one hop")
        node = self._level1(metapath[0])
        for ch in metapath[1:]:
            nxt = node.children.get(ch)
            if nxt is None:
                nxt = _Node(ch, node.depth + 1)
                nxt.callback = self._level1(ch)
                node.children[ch] = nxt
            node = nxt
        if not node.terminal:
            node.terminal = True
            self._size += 1

    def __contains__(self, metapath: str) -> bool:
        node = self.root
        for ch in metapath:
            node = node.children.get(ch)
            if node is None:
                return False
        return node.terminal

    def __len__(self) -> int:
        return self._size

    def longest_prefix(self, candidate: str) -> Optional[str]:
        """Longest materialized metapath that is a prefix of ``candidate``."""
        node = self.root
        best = None
        for i, ch in enumerate(candidate):
            node = node.children.get(ch)
            if node is None:
                break
            if node.terminal:
                best = candidate[: i + 1]
        return best

    def decompose(self, metapath: str) -> List[str]:
        """Matcher walk: split ``metapath`` into materialized segments.

        Segments overlap by one vertex type, e.g. ``["APS", "SP", "PA"]``
        for ``"APSPA"``.  Raises if some hop has no materialized relation.
        """
        if metapath in self:
            return [metapath]
        segs: List[str] = []
        pos = 0
        n = len(metapath)
        while pos < n - 1:
            seg = self.longest_prefix(metapath[pos:])
            if seg is None or len(seg) < 2:
                raise KeyError(
                    f"no materialized segment for {metapath[pos:]!r} "
                    f"(missing relation {metapath[pos:pos+2]!r}?)"
                )
            segs.append(seg)
            pos += len(seg) - 1
        return segs

    def materialized(self) -> List[str]:
        """All materialized metapaths (depth-first)."""
        out: List[str] = []

        def walk(node: _Node, prefix: str) -> None:
            if node.terminal:
                out.append(prefix)
            for ch in sorted(node.children):
                walk(node.children[ch], prefix + ch)

        for ch in sorted(self.root.children):
            walk(self.root.children[ch], ch)
        return out

    def nbytes(self) -> int:
        """Rough CTT buffer footprint: one 8-byte entry per node (type
        byte, next pointer, callback pointer, terminal flag), the figure
        held against the paper's 5 KB CTT buffer (Table 3)."""
        count = 0
        stack = [self.root]
        while stack:
            node = stack.pop()
            count += 1
            stack.extend(node.children.values())
        return count * 8
