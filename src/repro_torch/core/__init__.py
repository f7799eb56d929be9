from .conversation import Conversation, ConversationView, Turn, TurnView, view_of
from .scheduler import Placement, Scheduler, SCHEDULERS, make_scheduler
from .conserve import (ConServeRebalanceScheduler, ConServeScheduler,
                       ConServeSJFRefillScheduler)
from .baselines import AMPDScheduler, CollocatedScheduler, FullDisaggScheduler
from .signals import ClusterView, NodeState, PrefillLatencyCurve
from .events import (EventBus, ServeEvent, EVENT_KINDS, EV_SESSION,
                     EV_TOKENS, EV_TURN_FINISH, EV_ADMISSION_PARK,
                     EV_ADMISSION_ADMIT, EV_NODE_FAILURE, EV_RECOVERY)
from .runtime import (Admission, AdmissionQueue, Runtime, ServeSession,
                      SESSION_STATES, QUEUED, PREFILLING, TRANSFERRING,
                      DECODING, TOOL_WAIT, DONE)
from .provisioning import (NodeRates, WorkloadStats, min_decoders,
                           paper_configuration, prefiller_saturation_rate,
                           provision, slots_per_decoder)
from .metrics import (ConversationRecord, SLOThresholds, TurnRecord, gmean,
                      p95, per_turn_distributions, summarize)

__all__ = [n for n in dir() if not n.startswith("_")]
