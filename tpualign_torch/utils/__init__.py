from tpualign_torch.utils.device import resolve_device
from tpualign_torch.utils.logging import get_logger

__all__ = ["get_logger", "resolve_device"]
