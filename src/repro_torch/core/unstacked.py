"""The set of weight leaves WiSparse sparsifies (from the JAX package's
``core/unstacked.py``).  The per-depth calibration machinery of that
module comes with the calibration slice."""
from __future__ import annotations

# every channel-sparse linear in the zoo (attention q/k/v/o, MLP
# gate/up/down, SSM input/output projections); convs, norms, routers and
# the SSD recurrence stay dense
SPARSIFIABLE = {
    "wq", "wk", "wv", "wo", "wi_gate", "wi_up", "wi",
    "in_z", "in_x", "in_B", "in_C", "in_dt", "out_proj",
}
