"""The convex optimizer of the port (``ytklearn_tpu/optimize/``): L-BFGS
and OWL-QN over blocked loss/grad evaluation. FTRL comes with continual
training (ROADMAP.md 1.11)."""

from .lbfgs import LBFGSConfig, LBFGSResult, LBFGSState, inv_hessian_vp, \
    minimize_lbfgs

__all__ = ["LBFGSConfig", "LBFGSResult", "LBFGSState", "inv_hessian_vp",
           "minimize_lbfgs"]
