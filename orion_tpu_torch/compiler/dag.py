"""Network DAG over traced modules.

Counterpart of `orion_tpu/compiler/dag.py` (same code): a networkx
DiGraph of the traced net, residual fork/join discovery, fused-BN removal,
topological sort.  Nodes are module names from the tracer; each node carries its module
and stats.
"""

from __future__ import annotations

import networkx as nx


class NetworkDAG(nx.DiGraph):
    def __init__(self, tracer):
        super().__init__()
        self.tracer = tracer
        self.residuals: list[tuple[str, str]] = []  # (fork, join) pairs

    def build_dag(self):
        for name in self.tracer.order:
            node = self.tracer.nodes[name]
            if name == "_input":
                continue
            self.add_node(name, module=node.module, stats=node)
        for name in self.tracer.order:
            node = self.tracer.nodes[name]
            for p in node.parents:
                if p != "_input" and p in self.nodes and name in self.nodes:
                    self.add_edge(p, name)
        return self

    def input_nodes(self):
        return [n for n in self.nodes if self.in_degree(n) == 0]

    def output_nodes(self):
        return [n for n in self.nodes if self.out_degree(n) == 0]

    def topological_sort(self):
        return nx.topological_sort(self)

    # ----------------- residuals ----------------- #

    def find_residuals(self):
        """Fork/join pairs: a fork is a node with out-degree > 1; its join is
        the first common descendant of all its successor branches
        (reference `network_dag.py:36-76`)."""
        self.residuals = []
        topo = list(self.topological_sort())
        topo_pos = {n: i for i, n in enumerate(topo)}
        for fork in topo:
            if self.out_degree(fork) <= 1:
                continue
            descendants = [set(nx.descendants(self, s)) | {s}
                           for s in self.successors(fork)]
            common = set.intersection(*descendants)
            if not common:
                continue
            join = min(common, key=lambda n: topo_pos[n])
            self.residuals.append((fork, join))
        return self.residuals

    # ----------------- fused BN removal ----------------- #

    def remove_fused_batchnorms(self):
        """Splice out fused BATCHNORMS, reconnecting parents to children
        (reference `network_dag.py:125-148`).  Only BNs leave the graph: a
        fused Chebyshev merely had its [-1,1] prescale folded upstream and
        still evaluates its polynomial, so it must keep its DAG node (and
        receive a level + compile())."""
        from ..nn.normalization import BatchNormNd
        for name in list(self.nodes):
            module = self.nodes[name]["module"]
            if getattr(module, "fused", False) and \
                    isinstance(module, BatchNormNd):
                preds = list(self.predecessors(name))
                succs = list(self.successors(name))
                self.remove_node(name)
                for p in preds:
                    for s in succs:
                        self.add_edge(p, s)
