"""The five GEMMs' roofline bound a batch (float32 peak or bandwidth),
over the device time a batch of everything launched under
``synergy_matmul``."""
from benchkit.readers import roofline_pct


def read(r):
    return roofline_pct(r, r.driver.gemm_bound_s(r.config, r.traffic),
                        ("core/synergy_mm.py:synergy_matmul",))
