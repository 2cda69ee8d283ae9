"""Serving bucket fit (the port's copy of ``mxnet_tpu/ir/tune.py``
``fit_buckets``; the rest of that module is ROADMAP.md A.16)."""
from __future__ import annotations

__all__ = ["fit_buckets"]


def fit_buckets(size_counts, max_buckets=6, max_size=None):
    """The bucket set, at most ``max_buckets`` of the observed sizes, that
    minimises the pad rows of a measured request-size histogram
    ``{rows: count}`` (what ``ServeMetrics.request_rows`` gives). A
    deterministic dynamic program: the same histogram gives the same
    buckets in any process. ``max_size`` (the current largest bucket) is
    always covered, so a retune never shrinks what may be admitted. Ties
    go to fewer buckets."""
    counts = {int(s): int(c) for s, c in dict(size_counts).items()
              if int(s) > 0 and int(c) > 0}
    if max_size is not None:
        counts.setdefault(int(max_size), 0)
    if not counts:
        raise ValueError("fit_buckets needs a non-empty size histogram")
    sizes = sorted(counts)
    n = len(sizes)
    k = min(max(1, int(max_buckets)), n)
    # prefix sums: covering sizes[j..i] with bucket sizes[i] pads
    # (sizes[i] - s) rows for each request of size s
    pc = [0] * (n + 1)
    psc = [0] * (n + 1)
    for i, s in enumerate(sizes):
        pc[i + 1] = pc[i] + counts[s]
        psc[i + 1] = psc[i] + counts[s] * s

    def seg(j, i):
        return sizes[i] * (pc[i + 1] - pc[j]) - (psc[i + 1] - psc[j])

    inf = float("inf")
    dp = [[inf] * (k + 1) for _ in range(n)]
    back = [[-1] * (k + 1) for _ in range(n)]
    for i in range(n):
        dp[i][1] = seg(0, i)
        for b in range(2, k + 1):
            for j in range(1, i + 1):
                c = dp[j - 1][b - 1]
                if c == inf:
                    continue
                c += seg(j, i)
                if c < dp[i][b]:
                    dp[i][b] = c
                    back[i][b] = j - 1
    best_b = min(range(1, k + 1), key=lambda b: (dp[n - 1][b], b))
    buckets = []
    i, b = n - 1, best_b
    while i >= 0 and b >= 1:
        buckets.append(sizes[i])
        i, b = back[i][b], b - 1
    return tuple(sorted(buckets))
