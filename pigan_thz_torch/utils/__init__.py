from .logging import RunLogger
from .seed import set_seed
from .tensorboard import TfEventsWriter

__all__ = ["RunLogger", "TfEventsWriter", "set_seed"]
