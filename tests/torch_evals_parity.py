"""Checks shared by ``tests/test_torch_evals.py`` and
``tests/test_torch_train_then_sparsify.py``.

:func:`assert_metrics_close` holds ``eval_metrics`` at rtol 1e-5, the
KL with an absolute floor of 1e-8 besides: it is a mean of sums of p
(log p - log q) where the two log-probabilities nearly cancel, so f32
logits that agree to 1e-6 move a KL of 3e-4 by 3e-9 (1.06e-5 relative,
seen on the example's 40% plan).

:func:`assert_threshold_tie` shows that the JAX package's and the port's
alpha searches branched apart on an Eq. 7 threshold tie (ROADMAP Queue
3, reference behaviour 4), and on nothing else.

A calibrated tau is the value of one calibration score, so that element
sits exactly on it, and whether ``mask`` keeps it hangs on the last bit
of activations that the two packages compute in another order.  Where a
block's alphas differ between the two searches,
:func:`assert_threshold_tie` moves every tau of the block halfway down to
the next lower calibration score (off every element; the sp trees of
``tests/test_torch_calibration.py``), holds both packages' block errors
there at 1e-5 for both picks, requires them to part on the calibrated
taus at one pick at least, and holds the two picks' errors within
``rtol`` of each other in each package: a near-tie that one flipped
element decides."""
import jax
import numpy as np

from repro.core import alpha_search as JAS
from repro.core import unstacked as JU
from repro_torch.core import alpha_search as TAS
from repro_torch.models import params as P

TIE_FREE_RTOL = 1e-5
METRICS_RTOL = 1e-5
KL_ATOL = 1e-8


def assert_metrics_close(got: dict, want: dict):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=METRICS_RTOL,
                                   atol=KL_ATOL if k == "kl" else 0.0,
                                   err_msg=k)


def _t(tree):
    return P.from_numpy(jax.tree_util.tree_map(np.asarray, tree))


def tie_free(jctx, sp, depth, alphas):
    """Block ``depth``'s JAX sp dict with each finite tau moved halfway
    down to the next lower calibration score."""
    for path in jctx.keys_by_depth[depth]:
        key = (depth, path)
        tau = float(JU.get_sp_leaf(sp, path)["tau"])
        if np.isfinite(tau):
            s = jctx.scores_for(key, alphas[key])
            i = int(np.searchsorted(s, np.float32(tau)))
            low = float(s[i - 1]) if i > 0 else 0.0
            JU.set_sp_leaf(sp, path, "tau", 0.5 * (low + tau))
    return sp


def assert_threshold_tie(label, jctx, tctx, ja, ta, keep, rtol):
    """``ja`` / ``ta``: JAX's and the port's {key: alpha} at the keep
    ratios ``keep`` (both searches'); returns the blocks whose alphas
    differ, at least one."""
    assert ja.keys() == ta.keys()
    assert set(ja.values()) | set(ta.values()) <= set(JAS.GRID)
    branched = sorted({k[0] for k in ja if ja[k] != ta[k]})
    assert branched, f"{label}: the searches no longer branch apart"
    for d in branched:
        picks = {}
        for who, alphas in (("jax", ja), ("port", ta)):
            a = {k: v for k, v in alphas.items() if k[0] == d}
            sp = JAS._sp_for_block(jctx, jctx.layers[d], a, keep)
            free = tie_free(jctx, JAS._sp_for_block(
                jctx, jctx.layers[d], a, keep), d, a)
            errs = (float(jctx.block_mse(d, sp)), float(tctx.block_mse(
                d, TAS._sp_for_block(tctx, tctx.layers[d], a, keep))),
                float(jctx.block_mse(d, free)),
                float(tctx.block_mse(d, _t(free))))
            print(f"{label}: block {d}, the {who} pick "
                  f"{sorted(set(a.values()))}: block error JAX "
                  f"{errs[0]:.7e}, port {errs[1]:.7e}; tie-free JAX "
                  f"{errs[2]:.7e}, port {errs[3]:.7e}")
            np.testing.assert_allclose(errs[3], errs[2], rtol=TIE_FREE_RTOL)
            picks[who] = errs
        assert any(abs(e[1] - e[0]) > 10 * TIE_FREE_RTOL * e[0]
                   for e in picks.values()), f"{label}: no tie at block {d}"
        for i in (0, 1):
            np.testing.assert_allclose(picks["port"][i], picks["jax"][i],
                                       rtol=rtol)
    return branched
