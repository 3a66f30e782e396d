from repro_torch.runtime.fault_tolerance import (ElasticReassociator,
                                                 FailureInjector,
                                                 StragglerPolicy,
                                                 retry_with_backoff)

__all__ = ["ElasticReassociator", "FailureInjector", "StragglerPolicy",
           "retry_with_backoff"]
