from repro_torch.data.loader import (ShardedLoader, check_calib_coverage,
                                    validate_calib_features,
                                    validate_calib_tokens)
from repro_torch.data.synthetic import (CalibrationDataError, SyntheticLM,
                                        batches)

__all__ = ["CalibrationDataError", "ShardedLoader", "SyntheticLM",
           "batches", "check_calib_coverage", "validate_calib_features",
           "validate_calib_tokens"]
