from .kvcache import SlotKVCache
from .replica import ReplicaEngine, bucket_len
from .server import EngineServer
