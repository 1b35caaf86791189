"""Parse-tree structure for recursive autoencoders (reference
``nn/layers/feedforward/autoencoder/recursive/Tree.java:32`` — legacy
recursive-AE support: labeled n-ary trees carrying per-node vectors,
predictions and reconstruction errors).  Port of ``nn/recursive.py``, a
copy.

Kept as host-side plumbing: trees are irregular, data-dependent
structures.  The per-node ``vector`` / ``prediction`` payloads are
tensors or numpy arrays; batched tree math
belongs to whatever model consumes the traversal (e.g. pad-and-mask over
``get_leaves()`` order).
"""
from __future__ import annotations

from typing import Any, List, Optional, Sequence

__all__ = ["Tree"]


class Tree:
    """N-ary labeled tree node.  Mirrors the reference surface: tokens,
    type/value/label/goldLabel, vector/prediction payloads, children/parent
    links, error accumulation (``error``/``errorSum``), traversal helpers
    (``is_leaf``, ``is_pre_terminal``, ``depth``, ``ancestor``,
    ``get_leaves``, ``yield_words``), and deep ``clone``."""

    def __init__(self, tokens: Optional[Sequence[str]] = None,
                 parent: Optional["Tree"] = None):
        self.tokens: List[str] = list(tokens or [])
        self.parent: Optional[Tree] = parent
        self.children: List[Tree] = []
        self.type: Optional[str] = None
        self.value: Optional[str] = None
        self.label: Optional[str] = None
        self.gold_label: int = 0
        self.tags: List[str] = []
        self.vector: Any = None        # per-node embedding (Tree.java:360)
        self.prediction: Any = None    # per-node softmax (Tree.java:368)
        self.error: float = 0.0
        self.head_word: Optional[str] = None

    # ---------------------------------------------------------- structure --
    def is_leaf(self) -> bool:
        return not self.children

    def is_pre_terminal(self) -> bool:
        """Exactly one child, and that child is a leaf (Tree.java:162)."""
        return len(self.children) == 1 and self.children[0].is_leaf()

    def first_child(self) -> Optional["Tree"]:
        return self.children[0] if self.children else None

    def last_child(self) -> Optional["Tree"]:
        return self.children[-1] if self.children else None

    def depth(self) -> int:
        """Height below this node: 0 for a leaf (Tree.java:189)."""
        if self.is_leaf():
            return 0
        return 1 + max(c.depth() for c in self.children)

    def depth_of(self, node: "Tree") -> int:
        """Depth of ``node`` below this subtree, -1 if absent
        (Tree.java:210)."""
        if node is self:
            return 0
        for c in self.children:
            d = c.depth_of(node)
            if d >= 0:
                return d + 1
        return -1

    def ancestor(self, height: int, root: "Tree") -> Optional["Tree"]:
        """Ancestor ``height`` levels up, found via ``root``
        (Tree.java:258)."""
        node: Optional[Tree] = self
        for _ in range(height):
            node = node.parent_in(root) if node is not None else None
        return node

    def parent_in(self, root: "Tree") -> Optional["Tree"]:
        """Locate this node's parent by searching from ``root``
        (Tree.java:231 — the reference recomputes parents from the root
        rather than trusting the link)."""
        for c in root.children:
            if c is self:
                return root
            found = self.parent_in(c)
            if found is not None:
                return found
        return None

    # ------------------------------------------------------------- content --
    def yield_words(self) -> List[str]:
        """Leaf tokens, left to right (Tree.java:94 ``yield()``)."""
        if self.is_leaf():
            return list(self.tokens) if self.tokens else (
                [self.value] if self.value is not None else [])
        out: List[str] = []
        for c in self.children:
            out.extend(c.yield_words())
        return out

    def get_leaves(self) -> List["Tree"]:
        """All leaf nodes, left to right (Tree.java:300)."""
        if self.is_leaf():
            return [self]
        out: List[Tree] = []
        for c in self.children:
            out.extend(c.get_leaves())
        return out

    def error_sum(self) -> float:
        """This node's error plus all descendants' (Tree.java:278)."""
        return self.error + sum(c.error_sum() for c in self.children)

    def clone(self) -> "Tree":
        """Deep structural copy; payload arrays are shared (never written
        in place), host fields copied (Tree.java:325)."""
        t = Tree(self.tokens)
        t.type, t.value, t.label = self.type, self.value, self.label
        t.gold_label, t.tags = self.gold_label, list(self.tags)
        t.vector, t.prediction = self.vector, self.prediction
        t.error, t.head_word = self.error, self.head_word
        for c in self.children:
            cc = c.clone()
            cc.parent = t
            t.children.append(cc)
        return t

    def connect(self, children: Sequence["Tree"]) -> None:
        """Attach children, fixing parent links (Tree.java ``connect``)."""
        self.children = list(children)
        for c in self.children:
            c.parent = self

    def __repr__(self):
        kind = "leaf" if self.is_leaf() else f"{len(self.children)} children"
        return f"Tree({self.label or self.value or self.tokens}, {kind})"
