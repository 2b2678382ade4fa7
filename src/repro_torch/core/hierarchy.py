"""Host-side taxonomy machinery (the paper's HermiT-classification stage).

The paper feeds the ontology through an OWL reasoner (HermiT) to obtain the
*inferred* entity hierarchy before encoding.  We implement the RDFS-level
fragment of that classification ourselves:

  * transitive closure of subClassOf / subPropertyOf,
  * equivalence-cycle merging (A <= B <= A  =>  same encoding slot),
  * attachment of parentless entities under the root (owl:Thing / the
    property root),
  * DAG -> tree reduction for the bit-prefix encoder: each node keeps its
    *deepest* parent as the primary (tree) parent; remaining non-redundant
    parents become *secondary edges*.  Secondary edges are what multiple
    inheritance leaves behind; the encoder turns them into per-concept
    "spill intervals" so interval queries stay complete (DESIGN.md §2.2).

Everything here is plain Python/numpy on the host — it mirrors the paper's
single-machine TBox stage.  The *encoding* itself (tbox.py) additionally has
a parallel JAX path.
"""
from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np

ROOT = "__root__"


@dataclass
class Taxonomy:
    """A classified entity hierarchy, ready for prefix encoding.

    ``parent[i]`` is the primary (tree) parent index, -1 for the root.
    ``secondary`` holds the remaining direct-parent edges ``(child, parent)``
    that the tree could not represent.  ``merged`` maps each original name to
    its representative (equivalence classes from subsumption cycles).
    """

    names: list  # representative names, index == node id; names[0] == ROOT
    parent: np.ndarray  # int32[C] primary parent index
    depth: np.ndarray  # int32[C] depth in the *tree* (root = 0)
    secondary: list  # list[(child_idx, parent_idx)]
    merged: dict  # original name -> representative name
    index: dict = field(default_factory=dict)  # representative name -> idx

    def __post_init__(self):
        if not self.index:
            self.index = {n: i for i, n in enumerate(self.names)}

    @property
    def n(self) -> int:
        return len(self.names)

    def children(self):
        """children[i] = sorted list of primary children of i."""
        ch = [[] for _ in range(self.n)]
        for i, p in enumerate(self.parent.tolist()):
            if p >= 0:
                ch[p].append(i)
        return ch

    def idx_of(self, name: str) -> int:
        return self.index[self.merged.get(name, name)]

    def dag_parents(self):
        """parents[i] = all direct parents (primary + secondary)."""
        par = [[] for _ in range(self.n)]
        for i, p in enumerate(self.parent.tolist()):
            if p >= 0:
                par[i].append(p)
        for c, p in self.secondary:
            par[c].append(p)
        return par

    def dag_ancestors(self, i: int) -> set:
        """All strict DAG ancestors of node i (primary + secondary edges)."""
        par = self.dag_parents()
        seen, stack = set(), [i]
        while stack:
            for p in par[stack.pop()]:
                if p not in seen:
                    seen.add(p)
                    stack.append(p)
        return seen

    def dag_descendants(self, i: int) -> set:
        """All strict DAG descendants of node i."""
        ch = [[] for _ in range(self.n)]
        for c, ps in enumerate(self.dag_parents()):
            for p in ps:
                ch[p].append(c)
        seen, stack = set(), [i]
        while stack:
            for c in ch[stack.pop()]:
                if c not in seen:
                    seen.add(c)
                    stack.append(c)
        return seen


def _tarjan_scc(n: int, adj) -> np.ndarray:
    """Iterative Tarjan; returns comp[i] = SCC id (reverse topological)."""
    index = np.full(n, -1, dtype=np.int64)
    low = np.zeros(n, dtype=np.int64)
    on_stack = np.zeros(n, dtype=bool)
    comp = np.full(n, -1, dtype=np.int64)
    stack: list = []
    next_index = 0
    n_comp = 0
    for root in range(n):
        if index[root] != -1:
            continue
        work = [(root, 0)]
        while work:
            v, pi = work[-1]
            if pi == 0:
                index[v] = low[v] = next_index
                next_index += 1
                stack.append(v)
                on_stack[v] = True
            recurse = False
            for j in range(pi, len(adj[v])):
                w = adj[v][j]
                if index[w] == -1:
                    work[-1] = (v, j + 1)
                    work.append((w, 0))
                    recurse = True
                    break
                elif on_stack[w]:
                    low[v] = min(low[v], index[w])
            if recurse:
                continue
            if low[v] == index[v]:
                while True:
                    w = stack.pop()
                    on_stack[w] = False
                    comp[w] = n_comp
                    if w == v:
                        break
                n_comp += 1
            work.pop()
            if work:
                u, _ = work[-1]
                low[u] = min(low[u], low[v])
    return comp


def build_taxonomy(entities, sub_edges, root_name: str = ROOT) -> Taxonomy:
    """Classify (entity names, (sub, super) axioms) into a Taxonomy.

    This is the reasoner-lite stage: cycles are merged into equivalence
    classes, parentless entities hang off the root, transitively-redundant
    direct parents are dropped, and the deepest remaining parent becomes the
    tree parent.
    """
    names = list(dict.fromkeys([root_name, *entities]))
    for s, o in sub_edges:
        for t in (s, o):
            if t not in names:
                names.append(t)
    idx = {n: i for i, n in enumerate(names)}
    n = len(names)

    # --- SCC merge (equivalence cycles) -----------------------------------
    adj = [[] for _ in range(n)]
    for s, o in sub_edges:
        if s != o:
            adj[idx[s]].append(idx[o])
    comp = _tarjan_scc(n, adj)
    # representative of each SCC = smallest original index (keeps ROOT first)
    rep_of_comp: dict = {}
    for i in range(n):
        c = int(comp[i])
        if c not in rep_of_comp or i < rep_of_comp[c]:
            rep_of_comp[c] = i
    merged = {}
    for i in range(n):
        r = rep_of_comp[int(comp[i])]
        if r != i:
            merged[names[i]] = names[r]

    kept = sorted({rep_of_comp[int(c)] for c in comp})
    remap = {old: new for new, old in enumerate(kept)}
    rep_names = [names[i] for i in kept]
    root = remap[idx[root_name]]
    assert root == 0, "root must stay at index 0"
    m = len(kept)

    # --- direct-parent sets on the merged DAG -----------------------------
    parents = [set() for _ in range(m)]
    for s, o in sub_edges:
        si = remap[rep_of_comp[int(comp[idx[s]])]]
        oi = remap[rep_of_comp[int(comp[idx[o]])]]
        if si != oi:
            parents[si].add(oi)
    for i in range(m):
        if i != root and not parents[i]:
            parents[i].add(root)

    # --- longest-path depth (topological over the DAG) --------------------
    children = [set() for _ in range(m)]
    indeg = np.zeros(m, dtype=np.int64)
    for c in range(m):
        for p in parents[c]:
            children[p].add(c)
            indeg[c] += 1
    depth = np.zeros(m, dtype=np.int32)
    queue = [i for i in range(m) if indeg[i] == 0]
    order = []
    while queue:
        v = queue.pop()
        order.append(v)
        for c in children[v]:
            depth[c] = max(depth[c], depth[v] + 1)
            indeg[c] -= 1
            if indeg[c] == 0:
                queue.append(c)
    if len(order) != m:
        raise ValueError("cycle survived SCC merge — classification bug")

    # --- transitive reduction of direct parents, primary = deepest --------
    anc_cache: dict = {}

    def ancestors(i: int) -> set:
        if i in anc_cache:
            return anc_cache[i]
        acc = set()
        for p in parents[i]:
            acc.add(p)
            acc |= ancestors(p)
        anc_cache[i] = acc
        return acc

    parent_arr = np.full(m, -1, dtype=np.int32)
    secondary = []
    for i in range(m):
        if i == root:
            continue
        ps = parents[i]
        # drop parents that are ancestors of another parent (redundant)
        reduced = {p for p in ps if not any(p in ancestors(q) for q in ps if q != p)}
        primary = max(reduced, key=lambda p: (int(depth[p]), -p))
        parent_arr[i] = primary
        for p in sorted(reduced - {primary}):
            secondary.append((i, p))

    # tree depth (may differ from DAG depth once secondary edges are split)
    tree_depth = np.zeros(m, dtype=np.int32)
    for v in order:
        p = parent_arr[v]
        if p >= 0:
            tree_depth[v] = tree_depth[p] + 1

    return Taxonomy(
        names=rep_names,
        parent=parent_arr,
        depth=tree_depth,
        secondary=secondary,
        merged=merged,
    )
