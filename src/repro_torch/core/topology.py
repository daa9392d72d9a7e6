"""Topology forest, copied from ``repro.core.topology``: each tree root is
a resource type; zones, racks and hosts refine it; leaves are resource
instances (paper §4.3)."""
from __future__ import annotations

from dataclasses import dataclass, field
from typing import Dict, List, Optional, Tuple


@dataclass
class Node:
    node_id: int
    name: str                  # "H100/z0/r1/h2/g3" style path
    rtype: str                 # resource type (tree identity)
    level: int                 # 0 = type root
    parent: Optional[int]
    children: List[int] = field(default_factory=list)

    @property
    def is_leaf(self) -> bool:
        return not self.children


class Topology:
    """Immutable forest; precomputes leaf lists and ancestor paths."""

    def __init__(self) -> None:
        self.nodes: List[Node] = []
        self.roots: Dict[str, int] = {}       # rtype -> root node id
        self._leaves: Dict[int, List[int]] = {}
        self._ancestors: Dict[int, Tuple[int, ...]] = {}

    def add_node(self, name: str, rtype: str, parent: Optional[int]) -> int:
        nid = len(self.nodes)
        level = 0 if parent is None else self.nodes[parent].level + 1
        self.nodes.append(Node(nid, name, rtype, level, parent))
        if parent is None:
            self.roots[rtype] = nid
        else:
            self.nodes[parent].children.append(nid)
        return nid

    def freeze(self) -> "Topology":
        for n in self.nodes:
            path = []
            cur: Optional[int] = n.node_id
            while cur is not None:
                path.append(cur)
                cur = self.nodes[cur].parent
            self._ancestors[n.node_id] = tuple(path)  # self ... root

        def collect(nid: int) -> List[int]:
            n = self.nodes[nid]
            if n.is_leaf:
                self._leaves[nid] = [nid]
            else:
                acc: List[int] = []
                for c in n.children:
                    acc.extend(collect(c))
                self._leaves[nid] = acc
            return self._leaves[nid]
        for r in self.roots.values():
            collect(r)
        return self

    def leaves_of(self, nid: int) -> List[int]:
        return self._leaves[nid]

    def ancestors(self, nid: int) -> Tuple[int, ...]:
        """self, parent, ..., root."""
        return self._ancestors[nid]

    def covers(self, scope: int, leaf: int) -> bool:
        return scope in self._ancestors[leaf]

    def node(self, nid: int) -> Node:
        return self.nodes[nid]

    def n_leaves(self) -> int:
        return sum(1 for n in self.nodes if n.is_leaf)

    def common_scope(self, a: int, b: int) -> int:
        """Lowest common ancestor of two nodes in the same tree."""
        pa = set(self._ancestors[a])
        for nid in self._ancestors[b]:
            if nid in pa:
                return nid
        raise ValueError("nodes are in different trees")

    def depth(self) -> int:
        return max((len(p) for p in self._ancestors.values()), default=0)


def build_cluster(type_counts: Dict[str, int], *, gpus_per_host: int = 8,
                  hosts_per_rack: int = 4, racks_per_zone: int = 4
                  ) -> Topology:
    """Standard forest: type -> zone -> rack -> host(NVLink) -> gpu leaves;
    partial zones, racks and hosts are created as needed."""
    topo = Topology()
    for rtype, count in type_counts.items():
        root = topo.add_node(rtype, rtype, None)
        made = 0
        zi = 0
        while made < count:
            zone = topo.add_node(f"{rtype}/z{zi}", rtype, root)
            for ri in range(racks_per_zone):
                if made >= count:
                    break
                rack = topo.add_node(f"{rtype}/z{zi}/r{ri}", rtype, zone)
                for hi in range(hosts_per_rack):
                    if made >= count:
                        break
                    host = topo.add_node(f"{rtype}/z{zi}/r{ri}/h{hi}",
                                         rtype, rack)
                    for gi in range(gpus_per_host):
                        if made >= count:
                            break
                        topo.add_node(f"{rtype}/z{zi}/r{ri}/h{hi}/g{gi}",
                                      rtype, host)
                        made += 1
            zi += 1
    return topo.freeze()
