"""Network visualization (counterpart of ``mxnet_tpu/visualization.py``;
ref: python/mxnet/visualization.py)."""
from __future__ import annotations

from .symbol import _topo

__all__ = ["print_summary", "plot_network"]


def print_summary(symbol, shape=None, line_length=120):
    """Print one row per node (name, op, inputs), inputs before their
    users, and return the rows."""
    rows = [(s.name, s._op or "Variable", ",".join(i.name for i in s._inputs))
            for s in _topo(symbol)]
    widths = (40, 24, 50)
    print("  ".join(h.ljust(w) for h, w in
                    zip(("Layer (type)", "Op", "Inputs"), widths)))
    print("=" * line_length)
    for row in rows:
        print("  ".join(str(c)[:w].ljust(w) for c, w in zip(row, widths)))
    print("=" * line_length)
    print("Total nodes: %d" % len(rows))
    return rows


def plot_network(symbol, title="plot", **kwargs):
    """The graph as Graphviz dot source (rendering it needs graphviz)."""
    lines = ["digraph %s {" % title]
    ids = {}
    for s in _topo(symbol):
        nid = ids[id(s)] = "n%d" % len(ids)
        lines.append('  %s [label="%s\\n%s"];' % (nid, s.name,
                                                  s._op or "var"))
        for i in s._inputs:
            lines.append("  %s -> %s;" % (ids[id(i)], nid))
    lines.append("}")
    return "\n".join(lines)
