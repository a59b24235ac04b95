"""Adaptive Huffman tree, Vitter's algorithm (counterpart of
deflate_compression_tpu/core/aht.py, a host copy with its names, scores and
depths).

A cost model, not a coder: `score` = sum of weight x depth is the exact
optimal compressed bit count of the symbol stream so far (by Gallager's
theorem it equals the static optimal Huffman cost of the running
histogram after every insert). Vitter's slide-and-increment variant:
  * implicit numbering as a doubly linked list over all live nodes,
    ascending number order; blocks are maximal runs of equal (weight,
    leaf/internal class), the leader the highest-numbered member;
  * the NYT node splits on a symbol's first occurrence;
  * at most one leaf interchange per insert, with an O(1) score delta;
  * the climb to the root by slide-and-increment (a weight-w leaf slides
    past the weight-w internal nodes; a weight-w internal node past the
    weight-(w+1) leaves), depths cascading with incremental score updates;
  * the deferred increment of a leaf whose sibling is the NYT;
  * `check()` asserts the score, weights and Vitter's list invariants;
    `dump()` prints the tree.
The trace of utils/trace.py drives two of these per token on the host.
"""
from __future__ import annotations


class _Node:
    __slots__ = ("weight", "sym", "parent", "left", "right", "depth",
                 "prev", "next")

    def __init__(self, weight=0, sym=None, parent=None, depth=0):
        self.weight = weight
        self.sym = sym          # symbol for real leaves, None otherwise
        self.parent = parent
        self.left = None
        self.right = None
        self.depth = depth
        # doubly-linked implicit-numbering list; `next` = higher number
        self.prev = None
        self.next = None

    @property
    def is_leaf(self):
        return self.left is None


class AdaptiveHuffmanTree:
    """Adaptive Huffman tree over an integer symbol alphabet (Vitter)."""

    def __init__(self, alphabet_size: int = 286):
        self.alphabet_size = alphabet_size
        self.root = _Node(weight=0)
        self.nyt = self.root
        self.leaves: dict[int, _Node] = {}
        self._score = 0
        self.interchanges = 0      # swaps performed (Vitter: ≤1 per insert)
        self._last_insert_interchanges = 0

    # ------------------------------------------------------------------ api
    def insert(self, sym: int) -> None:
        """Account one symbol occurrence (reference aht_insert aht.c:239-277)."""
        swaps_before = self.interchanges
        q = self.leaves.get(sym)
        l2i = None                              # deferred leaf to increment
        if q is None:
            # split NYT: it becomes internal with children (new NYT, leaf c).
            # List order (ascending number): newNYT, leaf, old-NYT-internal
            # (reference aht_insert :244-262).
            p = self.nyt
            new_nyt = _Node(weight=0, parent=p, depth=p.depth + 1)
            leaf = _Node(weight=0, sym=sym, parent=p, depth=p.depth + 1)
            p.left, p.right = new_nyt, leaf
            # splice into list where old NYT (list head) was
            leaf.next = p
            leaf.prev = new_nyt
            new_nyt.next = leaf
            new_nyt.prev = None
            p.prev = leaf          # p keeps its old .next
            self.nyt = new_nyt
            self.leaves[sym] = leaf
            l2i = leaf
            q = p                  # climb from the new internal 0-node
        else:
            # interchange q with its block leader (O(1) score delta; here
            # the delta is 0 since leader shares q's weight)
            leader = self._block_leader(q)
            if leader is not q:
                self._swap(q, leader)
            if self._sibling(q) is self.nyt:
                l2i = q
                q = q.parent
        while q is not None:
            q = self._sai(q)
        if l2i is not None:
            self._sai(l2i)
        self._last_insert_interchanges = self.interchanges - swaps_before

    @property
    def score(self) -> int:
        """Σ weight·depth, maintained incrementally (running optimal bit
        count; reference aht.h score field, O(1) deltas aht.c:59,129,206)."""
        return self._score

    def depths(self) -> dict[int, int]:
        return {s: leaf.depth for s, leaf in self.leaves.items()}

    # ----------------------------------------------------------- invariants
    def check(self) -> None:
        """Invariant checker (reference aht_check_score aht.c:330-349), plus
        Vitter's list-shape invariants the reference maintains implicitly."""
        total = 0
        for leaf in self.leaves.values():
            d = 0
            n = leaf
            while n.parent is not None:
                d += 1
                n = n.parent
            assert d == leaf.depth, "stale depth field"
            total += leaf.weight * d
        assert total == self.score, f"score {self.score} != recomputed {total}"

        def wsum(n):
            if n.is_leaf:
                return n.weight
            w = wsum(n.left) + wsum(n.right)
            assert n.weight == w, "internal weight mismatch"
            return w
        wsum(self.root)

        # walk the implicit-numbering list head→tail (ascending number):
        # weights nondecreasing; within a weight, leaves precede internal
        # nodes (Vitter's invariant); children precede parents; list is
        # consistent and covers every node exactly once.
        seen = set()
        order = []
        n = self.nyt
        assert n.prev is None, "list head must be the NYT"
        while n is not None:
            assert id(n) not in seen, "list cycle"
            seen.add(id(n))
            order.append(n)
            if n.next is not None:
                assert n.next.prev is n, "broken back-link"
            n = n.next
        assert order[-1] is self.root, "list tail must be the root"
        assert len(order) == 2 * len(self.leaves) + 1, "list misses nodes"
        pos = {id(n): i for i, n in enumerate(order)}
        for a, b in zip(order, order[1:]):
            assert a.weight <= b.weight, "weight ordering violated"
            if a.weight == b.weight:
                assert not (not a.is_leaf and b.is_leaf), \
                    "Vitter invariant: leaf after internal in same block"
        for n in order:
            if n.parent is not None:
                assert pos[id(n.parent)] > pos[id(n)], \
                    "parent numbering violated"

    def dump(self, node=None, depth=0, out=None, color=False) -> str:
        """ASCII tree dump with INLINE diagnostics, mirroring the
        reference's aht_print (aht.c:279-328): a node whose stored depth
        disagrees with its actual tree depth is flagged in place (the
        reference marks it with ANSI red, aht.c:298-301); `color=True`
        reproduces the ANSI coloring (leaves green, internals cyan,
        mismatches red)."""
        top = out is None
        if out is None:
            out = []
            node = self.root
        tag = (f"leaf[{node.sym}]" if node.is_leaf and node.sym is not None
               else ("NYT" if node.is_leaf else "int"))
        line = f"{tag} w={node.weight} d={node.depth}"
        bad = node.depth != depth
        if bad:
            line += f" <-- DEPTH MISMATCH (actual {depth})"
        if color:
            c = "31" if bad else ("32" if node.is_leaf else "36")
            line = f"\x1b[{c}m{line}\x1b[0m"
        out.append("  " * depth + line)
        if not node.is_leaf:
            self.dump(node.right, depth + 1, out, color)
            self.dump(node.left, depth + 1, out, color)
        return "\n".join(out) if top else ""

    # ------------------------------------------------------------ internals
    def _block_leader(self, q):
        """Highest-numbered node of q's block — walk the list while weight
        and class match (reference aht_get_block_leader aht.c:30-40)."""
        while q.next is not None:
            n = q.next
            if q.weight != n.weight or (q.is_leaf != n.is_leaf):
                break
            q = n
        return q

    @staticmethod
    def _sibling(q):
        p = q.parent
        if p is None:
            return None
        return p.right if p.left is q else p.left

    def _cascade_depth(self, n, d):
        """Set n's subtree depths to d..; score updated per leaf (reference
        aht_cascade_update_depth aht.c:42-62)."""
        stack = [(n, d)]
        while stack:
            m, dd = stack.pop()
            if m.is_leaf:
                self._score += (dd - m.depth) * m.weight
            else:
                stack.append((m.left, dd + 1))
                stack.append((m.right, dd + 1))
            m.depth = dd

    def _sai(self, p):
        """Slide-and-increment: returns the next node to update on the path
        to the root (reference aht_sai aht.c:115-139)."""
        wt = p.weight
        s = p.parent                     # internal node continues from OLD parent
        b = self._block_leader(p)
        if b.next is None:               # p's block leader is the root
            nxt = None
        else:
            b = b.next
            if ((p.is_leaf and not b.is_leaf and b.weight == wt)
                    or (not p.is_leaf and b.is_leaf and b.weight == wt + 1)):
                self._slide(p, self._block_leader(b))
            if p.is_leaf:
                self._score += p.depth   # weight goes wt -> wt+1 at depth
                s = p.parent             # leaf continues from NEW parent
            nxt = s
        p.weight += 1
        return nxt

    def _slide(self, n, b):
        """Slide n to just after b in number order: every node strictly
        between shifts down one slot in the tree; n takes b's old slot
        (reference aht_slide aht.c:64-113)."""
        orig = n
        b_par = b.parent
        # unlink orig from the list (orig.next stays valid for the walk)
        if n.prev is not None:
            n.prev.next = n.next
        else:
            self.nyt = n.next if n is self.nyt else self.nyt
        n.next.prev = n.prev
        prev_par = n.parent
        p = n.parent
        while n is not b:
            m = n.next
            # m takes n's old tree slot under p
            if p.right is n:
                p.right = m
            else:
                p.left = m
            if m.depth != p.depth + 1:
                self._cascade_depth(m, p.depth + 1)
            p = m.parent
            m.parent = prev_par
            prev_par = p
            n = m
        # orig takes b's old slot under b_par
        p = b_par
        if p.right is b:
            p.right = orig
        else:
            p.left = orig
        if orig.depth != p.depth + 1:
            self._cascade_depth(orig, p.depth + 1)
        orig.parent = b_par
        # relink orig into the list right after b
        if b.next is not None:
            b.next.prev = orig
        orig.next = b.next
        orig.prev = b
        b.next = orig

    def _swap(self, a, b):
        """Exchange a's and b's tree positions, numbers, and depths, with an
        O(1) score delta (reference aht_swap aht.c:141-212). Only called on
        leaves of one block (a subordinate to b)."""
        self.interchanges += 1
        adj = a.next is b
        # list surgery (reference's forward/backward arrow dance, :155-176)
        t = a.next
        a.next = b.next
        if a.prev is not None:
            a.prev.next = b
        if adj:
            b.next = a
        else:
            b.next = t
            b.prev.next = a
        a.next.prev = a            # b.next existed: b was a's superior
        t = a.prev
        if adj:
            a.prev = b
        else:
            a.prev = b.prev
        b.prev = t
        if not adj:
            b.next.prev = b
        if b.prev is None:
            self.nyt = b if a is self.nyt else self.nyt
        # parents (reference :179-203)
        pa = a.parent
        if a.parent is b.parent:
            pa.left, pa.right = pa.right, pa.left
        else:
            if pa.right is a:
                pa.right = b
            else:
                pa.left = b
            pb = b.parent
            if pb.right is b:
                pb.right = a
            else:
                pb.left = a
            a.parent, b.parent = pb, pa
        # depths + O(1) score delta (reference :206-211)
        if a.depth != b.depth:
            self._score += (a.depth - b.depth) * (b.weight - a.weight)
            a.depth, b.depth = b.depth, a.depth


def aht_cost_trace(symbols, alphabet_size: int = 286):
    """Cumulative optimal-bits trace, one entry per symbol — the reference's
    telemetry format B (`bytes, compressed_bits`, results/results_.txt:1;
    SURVEY §6)."""
    t = AdaptiveHuffmanTree(alphabet_size)
    out = []
    for s in symbols:
        t.insert(int(s))
        out.append(t.score)
    return out
