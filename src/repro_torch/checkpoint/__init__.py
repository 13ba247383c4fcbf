from .checkpoint import (save, restore, peek, latest_step,  # noqa: F401
                         list_steps)
