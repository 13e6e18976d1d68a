from .logging import RunLogger
from .tensorboard import TfEventsWriter

__all__ = ["RunLogger", "TfEventsWriter"]
