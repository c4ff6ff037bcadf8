from repro_torch.core.baselines import gptq_quantize, rtn_quantize
from repro_torch.core.comq import QuantResult, make_orders
from repro_torch.core.comq_hessian import (comq_quantize_blocked,
                                           comq_quantize_h, gram,
                                           panel_sweep_dq_ref, shared_order)
from repro_torch.core.pipeline import (QuantReport, materialize,
                                       quantize_model)
from repro_torch.core.quantizer import QuantSpec

__all__ = ["QuantReport", "QuantResult", "QuantSpec", "comq_quantize_blocked",
           "comq_quantize_h", "gptq_quantize", "gram", "make_orders",
           "materialize", "panel_sweep_dq_ref", "quantize_model",
           "rtn_quantize", "shared_order"]
