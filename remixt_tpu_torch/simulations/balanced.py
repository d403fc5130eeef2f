"""Minimal breakpoint copy number via balanced-cycle cancellation.

Counterpart of ``remixt_tpu/simulations/balanced.py``, the ground-truth
minimization the simulation's evaluation scores breakpoint copy number
against: repeatedly find families of *balanced alternating cycles* —
closed walks alternating variant (breakpoint) edges and wild-type
adjacency edges over breakend nodes — and cancel one copy of every variant
edge on such a cycle, until no balanced family remains.

The balanced family is found with the doubled-graph reduction: every
breakend node is split into a variant-layer and a reference-layer twin
joined by a unit-cost *transverse* edge, while variant and adjacency edges
connect twins within their own layer at zero cost. A minimum-cost perfect
matching (networkx's blossom implementation) then prefers zero-cost layer
edges, and the symmetric difference of the matched layer edges traces the
balanced cycles. A perfect matching always exists because every node can
fall back to its transverse edge. Which of several tied matchings is
chosen decides the truth, so the graph is built in the JAX package's
order and matched by the same networkx routine; networkx is imported
inside the function that matches.
"""

import numpy as np


def _prune_to_variant_components(variant_edges, reference_edges):
    """Drop reference edges in components with no variant edge.

    A balanced cycle alternates variant and reference edges, so only the
    connected components (over the union graph) touching a variant edge
    can cancel anything. Every breakend has at most one wild-type partner
    and variant edges are few, so the surviving subgraph is small.
    """
    neighbours = {}
    for u, v in list(variant_edges) + list(reference_edges):
        neighbours.setdefault(u, []).append(v)
        neighbours.setdefault(v, []).append(u)

    reachable = set()
    stack = [node for edge in variant_edges for node in edge]
    while stack:
        node = stack.pop()
        if node in reachable:
            continue
        reachable.add(node)
        stack.extend(neighbours.get(node, ()))

    return [edge for edge in reference_edges
            if edge[0] in reachable or edge[1] in reachable]


def _matched_layer_pairs(variant_edges, reference_edges):
    """Run the doubled-graph matching; return the symmetric difference of
    matched same-layer edges as a set of frozenset breakend pairs."""
    import networkx

    reference_edges = _prune_to_variant_components(
        variant_edges, reference_edges)
    doubled = networkx.Graph()
    node_ids = {}

    def twin(node, layer):
        key = (node, layer)
        if key not in node_ids:
            node_ids[key] = (len(node_ids), node, layer)
        return node_ids[key][0]

    layered = (('variant', variant_edges), ('reference', reference_edges))
    for layer, edges in layered:
        for u, v in edges:
            a, b = twin(u, layer), twin(v, layer)
            if a != b:
                doubled.add_edge(a, b, weight=0.0)
    # transverse fallback edges, after all base nodes are known
    for _, node, layer in list(node_ids.values()):
        doubled.add_edge(
            twin(node, 'variant'), twin(node, 'reference'), weight=1.0)

    matching = networkx.min_weight_matching(doubled, weight='weight')

    by_id = {tid: (node, layer) for tid, node, layer in node_ids.values()}
    toggled = set()
    for a, b in matching:
        node_a, layer_a = by_id[a]
        node_b, layer_b = by_id[b]
        if node_a == node_b:
            continue  # transverse: node not on any cycle
        if layer_a != layer_b:
            raise RuntimeError('a matched edge joins two layers')
        toggled ^= {frozenset((node_a, node_b))}
    return toggled


def _allele_adjacency_edges(adjacencies):
    """Wild-type junction edges over breakend nodes, one per allele."""
    edges = []
    for left_seg, right_seg in adjacencies:
        for allele in (0, 1):
            edges.append((
                ((left_seg, allele), 1),
                ((right_seg, allele), 0),
            ))
    return edges


def minimize_breakpoint_copies(adjacencies, brk_cn):
    """Cancel balanced cycles out of per-clone breakpoint copy numbers
    until a fixpoint; returns a new {breakpoint: cn_vector} dict."""
    minimized = {bp: np.array(cn, dtype=float).copy()
                 for bp, cn in brk_cn.items()}
    if not minimized:
        return minimized

    num_clones = max(cn.shape[0] for cn in minimized.values())
    reference_edges = _allele_adjacency_edges(adjacencies)

    changed = True
    while changed:
        changed = False
        for m in range(num_clones):
            variant_edges = [
                tuple(bp) for bp, cn in minimized.items()
                if cn[m] > 0 and len(bp) == 2]
            for pair in _matched_layer_pairs(variant_edges, reference_edges):
                if pair in minimized:
                    if not minimized[pair][m] > 0:
                        raise RuntimeError('cancelling a copy the breakpoint '
                                           'does not have')
                    minimized[pair][m] -= 1
                    changed = True
    return minimized
