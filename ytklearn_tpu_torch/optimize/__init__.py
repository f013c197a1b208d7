"""The convex optimizers of the port (``ytklearn_tpu/optimize/``): L-BFGS
and OWL-QN over blocked loss/grad evaluation, and FTRL-proximal, the
streaming update of `cli retrain --mode ftrl`."""

from .ftrl import FTRLConfig, FTRLState, ftrl_init, ftrl_pass, make_ftrl_step
from .lbfgs import LBFGSConfig, LBFGSResult, LBFGSState, inv_hessian_vp, \
    minimize_lbfgs

__all__ = ["FTRLConfig", "FTRLState", "LBFGSConfig", "LBFGSResult",
           "LBFGSState", "ftrl_init", "ftrl_pass", "inv_hessian_vp",
           "make_ftrl_step", "minimize_lbfgs"]
