from repro_torch.core.baselines import gptq_quantize, rtn_quantize
from repro_torch.core.calibrate import GramAccumulator
from repro_torch.core.comq import QuantResult, comq_quantize, make_orders
from repro_torch.core.comq_hessian import (comq_quantize_blocked,
                                           comq_quantize_h, gram,
                                           panel_sweep_dq_ref, shared_order)
from repro_torch.core.guards import (GuardContext, GuardEvent,
                                     damped_inverse, guarded_solve)
from repro_torch.core.pipeline import (QuantReport, materialize,
                                       quantize_model)
from repro_torch.core.policy import (DEFAULT_BIT_CHOICES, QuantPolicy,
                                     allocate_bits, as_policy,
                                     measure_bit_curves, parse_policy,
                                     policy_from_budget)
from repro_torch.core.quantizer import QuantSpec

__all__ = ["DEFAULT_BIT_CHOICES", "GramAccumulator", "GuardContext",
           "GuardEvent", "QuantPolicy", "QuantReport", "QuantResult",
           "QuantSpec", "allocate_bits", "as_policy", "comq_quantize",
           "comq_quantize_blocked", "comq_quantize_h", "damped_inverse",
           "gptq_quantize", "gram", "guarded_solve", "make_orders",
           "materialize", "measure_bit_curves", "panel_sweep_dq_ref",
           "parse_policy", "policy_from_budget", "quantize_model",
           "rtn_quantize", "shared_order"]
