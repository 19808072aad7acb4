"""The share of the program-traced phase's K1 pre-layer and K2 launches that
took the instantiations for a pose of 65-128 dims, %: K1's pre route over two
K-tiles (``routes.dense_gn_silu.pre_wgmma2``) and K2's 128-column tile
(``routes.head_em.head128``, ``routes.head_em_impute.head128``), over those
and their one-tile and 64-column routes. 100 where every launch took them, 0
where they fell back; None where the program counts neither."""
from portbench.metrics._program import phase

WIDE = ("routes.dense_gn_silu.pre_wgmma2", "routes.head_em.head128",
        "routes.head_em_impute.head128")
NARROW = ("routes.dense_gn_silu.pre_wgmma", "routes.head_em.head64",
          "routes.head_em_impute.head64")


def read(run):
    p = phase(run)
    if p is None:
        return None
    wide = sum(p.counters.get(k, 0) for k in WIDE)
    total = wide + sum(p.counters.get(k, 0) for k in NARROW)
    return 100.0 * wide / total if total else None
