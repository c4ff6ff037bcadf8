from repro_torch.ft.inject import (FaultInjector, InjectedFault,  # noqa: F401
                                   SimulatedKill)
from repro_torch.ft.journal import (Journal, JournalCorrupt,  # noqa: F401
                                    JournalState, QuantJournal, QuantState,
                                    ResumeMismatch)
from repro_torch.ft.watchdog import (Heartbeat,  # noqa: F401
                                     RecoveryPlan, StragglerEvent, Watchdog,
                                     plan_recovery, run_with_restarts)
