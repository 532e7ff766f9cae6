from veneur_tpu_torch.proxy.proxy import ProxyServer  # noqa: F401
from veneur_tpu_torch.proxy.ring import ConsistentRing, EmptyRingError  # noqa: F401
