"""Radix index over page-aligned token runs.

A trimmed copy of ``dynamo_exp_tpu/kv/prefix.py`` (``PrefixIndex``):
hashes and each block's tokens, where known, for the partial-tail
lookup (:meth:`PrefixIndex.partial_match`, the copy-on-write attach of
a prompt ending inside a registered block), without the payloads the
port does not use. The engine's page manager and the KV router's
per-worker index (``kv_router/indexer.py``) share it. Each
indexed *block* is one full KV page's worth of tokens, identified by its
chained sequence hash (``tokens.py``): equal sequence hashes imply equal
full prefixes, so prefix containment is a chain walk. A node holds a
*run* of consecutive blocks and splits only where chains diverge.
Evicting a middle block detaches its descendants into an orphan set
keyed by the missing parent hash; re-registering that block re-attaches
them. Single-writer (the engine loop thread); no internal locking.
"""

from __future__ import annotations

from typing import Sequence


class _Node:
    """One compressed edge: a run of consecutive blocks. ``hashes[i]``
    is the chained sequence hash of the run's i-th block; ``tokens[i]``
    its token block, or None when only the hash is known (a router's
    index: KV events may carry no tokens)."""

    __slots__ = ("hashes", "tokens", "parent", "children", "orphan_key")

    def __init__(self, parent: "_Node | None" = None):
        self.hashes: list[int] = []
        self.tokens: list[tuple[int, ...] | None] = []
        self.parent = parent
        # first-block-hash -> child node (divergence points only).
        self.children: dict[int, "_Node"] = {}
        # The missing parent hash this node is parked under while
        # detached (None when attached) — makes unparking O(1).
        self.orphan_key: int | None = None


class PrefixIndex:
    """Radix tree over hash-chained token blocks.

    ``insert``/``remove`` are O(1) amortized via a block-location map;
    ``match_hashes`` is O(matched blocks).
    """

    def __init__(self):
        self._root = _Node()
        # seq_hash -> (node, index within the node's run).
        self._loc: dict[int, tuple[_Node, int]] = {}
        # Detached subtrees waiting for their parent block to come back
        # (evicted mid-chain): missing parent hash -> orphaned nodes.
        self._orphans: dict[int, list[_Node]] = {}

    @property
    def num_blocks(self) -> int:
        """All indexed blocks, including orphaned (detached) ones."""
        return len(self._loc)

    # --------------------------------------------------------------- insert
    def insert(
        self, parent_hash: int | None, seq_hash: int, tokens: Sequence[int] | None = None
    ) -> bool:
        """Index one block under its parent. Returns False (refreshing
        its tokens) when the block is already present. A missing parent
        parks the block as an orphan; it attaches the moment the parent
        is (re-)inserted."""
        tok = tuple(tokens) if tokens is not None else None
        if seq_hash in self._loc:
            if tok is not None:
                node, i = self._loc[seq_hash]
                node.tokens[i] = tok
            return False
        if parent_hash is None:
            self._attach_block(self._root, len(self._root.hashes), seq_hash, tok)
        elif parent_hash in self._loc:
            pnode, pidx = self._loc[parent_hash]
            self._attach_block(pnode, pidx + 1, seq_hash, tok)
        else:
            # Orphan: a one-block node parked until the parent shows up.
            node = _Node()
            node.hashes.append(seq_hash)
            node.tokens.append(tok)
            node.orphan_key = parent_hash
            self._loc[seq_hash] = (node, 0)
            self._orphans.setdefault(parent_hash, []).append(node)
        self._reattach_orphans(seq_hash)
        return True

    def _attach_block(
        self, node: _Node, at: int, seq_hash: int, tok: tuple[int, ...] | None
    ) -> None:
        """Place a new block as the successor of ``node.hashes[at-1]``
        (``at`` == run position the block would occupy)."""
        if at == len(node.hashes) and not node.children and node is not self._root:
            # Tail extension: the common case (a sequence registering
            # pages in order) stays one compressed run.
            node.hashes.append(seq_hash)
            node.tokens.append(tok)
            self._loc[seq_hash] = (node, at)
            return
        if at < len(node.hashes):
            self._split(node, at)  # divergence mid-run
        child = _Node(parent=node)
        child.hashes.append(seq_hash)
        child.tokens.append(tok)
        node.children[seq_hash] = child
        self._loc[seq_hash] = (child, 0)

    def _split(self, node: _Node, at: int) -> None:
        """Split ``node``'s run at ``at``: blocks [at:] move into a new
        child, making position ``at`` a branch point."""
        tail = _Node(parent=node)
        tail.hashes = node.hashes[at:]
        tail.tokens = node.tokens[at:]
        tail.children, node.children = node.children, {}
        for child in tail.children.values():
            child.parent = tail
        node.hashes = node.hashes[:at]
        node.tokens = node.tokens[:at]
        node.children[tail.hashes[0]] = tail
        for i, h in enumerate(tail.hashes):
            self._loc[h] = (tail, i)

    def _reattach_orphans(self, seq_hash: int) -> None:
        for node in self._orphans.pop(seq_hash, ()):  # children of seq_hash
            pnode, pidx = self._loc[seq_hash]
            if pidx < len(pnode.hashes) - 1:
                self._split(pnode, pidx + 1)
            node.parent = pnode
            node.orphan_key = None
            pnode.children[node.hashes[0]] = node

    # --------------------------------------------------------------- remove
    def remove(self, seq_hash: int) -> bool:
        """Drop one block (eviction). Descendants — later blocks of the
        same run and child subtrees — detach into the orphan set under
        this hash, re-attachable if the block is registered again."""
        loc = self._loc.pop(seq_hash, None)
        if loc is None:
            return False
        node, idx = loc
        # Everything after the removed block becomes a detached subtree
        # parented (logically) by the removed hash.
        if idx < len(node.hashes) - 1:
            self._split(node, idx + 1)
        orphan_children = list(node.children.values())
        node.children = {}
        node.hashes.pop()  # idx is now the last block
        node.tokens.pop()
        if orphan_children:
            self._orphans.setdefault(seq_hash, []).extend(orphan_children)
            for child in orphan_children:
                child.parent = None
                child.orphan_key = seq_hash
        if not node.hashes:
            if node.parent is not None:
                # Run emptied: unlink from the parent's child map.
                parent = node.parent
                for key, child in list(parent.children.items()):
                    if child is node:
                        del parent.children[key]
                        break
            elif node.orphan_key is not None:
                # A parked orphan node that empties vanishes — O(1) via
                # its recorded park key, not a scan of every bucket.
                bucket = self._orphans.get(node.orphan_key)
                if bucket is not None:
                    bucket[:] = [n for n in bucket if n is not node]
                    if not bucket:
                        del self._orphans[node.orphan_key]
        # else: the surviving run keeps its key block (idx == 0 empties
        # the node only when the run had length 1).
        return True

    # ---------------------------------------------------------------- match
    def match_hashes(self, hashes: Sequence[int]) -> list[int]:
        """Longest root-anchored run of ``hashes`` present in the index
        (page-aligned longest-prefix match). Returns the matched prefix
        of ``hashes``."""
        matched: list[int] = []
        node = self._root
        idx = len(node.hashes)  # root run is always empty
        for h in hashes:
            if idx < len(node.hashes):
                if node.hashes[idx] != h:
                    break
            else:
                child = node.children.get(h)
                if child is None:
                    break
                node, idx = child, 0
            matched.append(h)
            idx += 1
        return matched

    def coverage_blocks(self, hashes: Sequence[int]) -> int:
        """Length of the longest root-anchored match of ``hashes``."""
        return len(self.match_hashes(hashes))

    def partial_match(
        self, parent_hash: int | None, tail: Sequence[int]
    ) -> tuple[int, int] | None:
        """A registered block extending ``tail``: given the last fully
        matched block (``parent_hash``; None when the query is shorter
        than one page), a successor block whose stored tokens start with
        ``tail``. Returns (block seq_hash, covered tokens) or None.
        Blocks indexed without tokens never partial-match."""
        if not tail:
            return None
        if parent_hash is None:
            node, idx = self._root, len(self._root.hashes) - 1
        elif parent_hash in self._loc:
            node, idx = self._loc[parent_hash]
        else:
            return None
        tail = tuple(tail)
        # Successor candidates: the next block of the same run, else the
        # first block of each child (insertion order).
        if idx + 1 < len(node.hashes):
            candidates = [(node.hashes[idx + 1], node.tokens[idx + 1])]
        else:
            candidates = [(c.hashes[0], c.tokens[0]) for c in node.children.values()]
        for h, tok in candidates:
            if tok is not None and len(tok) >= len(tail) and tok[: len(tail)] == tail:
                return h, len(tail)
        return None
