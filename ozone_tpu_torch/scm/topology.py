"""Multi-level network topology: location paths, distance, nearest-first.

Port of `ozone_tpu/scm/topology.py` (the reference's NetworkTopologyImpl):
cluster locations form a tree ("/dc1/rack2", any depth), a node's full
path is its location plus the node itself, and the distance between two
nodes is the number of tree edges between them (getDistanceCost). The
datanode client factory orders replica reads nearest-first with it
(`client/dn_client.DatanodeClientFactory.nearest_first`), which feeds the
replicated reader and the EC reader's survivor choice. Locations are
plain strings shipped on the SCM address book; the tree is implicit in
their components.
"""

from __future__ import annotations

from typing import Iterable, Optional


def norm_location(loc: Optional[str]) -> tuple[str, ...]:
    """Split a location path into components ("/dc/rack" -> (dc, rack));
    empty or None is the root."""
    if not loc:
        return ()
    return tuple(p for p in loc.split("/") if p)


def distance(loc_a: Optional[str], loc_b: Optional[str],
             node_a: Optional[str] = None,
             node_b: Optional[str] = None) -> int:
    """Tree-edge distance between two nodes at the given locations: 0 for
    the same node, else (depth_a - common) + (depth_b - common) + 2, where
    common is the shared path prefix and the 2 the two node-to-location
    edges."""
    if node_a is not None and node_a == node_b:
        return 0
    a, b = norm_location(loc_a), norm_location(loc_b)
    common = 0
    for x, y in zip(a, b):
        if x != y:
            break
        common += 1
    return (len(a) - common) + (len(b) - common) + 2


def sort_by_distance(reader_loc: Optional[str],
                     nodes: Iterable[str],
                     locations: dict[str, str],
                     reader_node: Optional[str] = None) -> list[str]:
    """Nodes ordered nearest-first from the reader's position. Ties keep
    the input order; nodes of unknown location sort last, in input order."""
    seq = list(nodes)

    def key(item):
        i, dn = item
        if dn not in locations:
            return (9999, i)
        return (distance(reader_loc, locations[dn], node_a=reader_node,
                         node_b=dn), i)

    return [dn for _, dn in sorted(enumerate(seq), key=key)]
