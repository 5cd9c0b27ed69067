"""``decode_graph_share.serve`` (%): the share of the program's
``serve.decode`` spans in the traced window that hold a
``serve.decode_graph`` span (a replay of the backend's CUDA graph of the
cache step), in the same process.  0.0 where the decodes replay no graph;
None outside a serving trace or where it holds no decode.  Layer: the
serving backend.  Moves ``serve_tokens_per_s``."""

import bisect
from collections import defaultdict

from perfbench import spans


def read(t):
    if t.get("phase") != "serve":
        return None
    decodes = spans.spans(t["events"], "serve.decode")
    if not decodes:
        return None
    starts = defaultdict(list)
    for g in spans.spans(t["events"], "serve.decode_graph"):
        starts[g.get("pid")].append(g["ts"])
    for s in starts.values():
        s.sort()
    held = 0
    for d in decodes:
        s = starts.get(d.get("pid"), [])
        i = bisect.bisect_left(s, d["ts"])
        held += i < len(s) and s[i] <= d["ts"] + d["dur"]
    return 100.0 * held / len(decodes)
