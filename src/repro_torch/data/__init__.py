from repro_torch.data.loader import (check_calib_coverage,
                                    validate_calib_features,
                                    validate_calib_tokens)
from repro_torch.data.synthetic import CalibrationDataError

__all__ = ["CalibrationDataError", "check_calib_coverage",
           "validate_calib_features", "validate_calib_tokens"]
