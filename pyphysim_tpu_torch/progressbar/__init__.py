"""Progress display (layer: observability)."""

from .progressbar import (DummyProgressbar, ProgressBarBase,  # noqa: F401
                          ProgressBarIPython,
                          ProgressbarDistributedClientBase,
                          ProgressbarDistributedServerBase,
                          ProgressbarMultiProcessClient,
                          ProgressbarMultiProcessServer, ProgressbarText,
                          ProgressbarText2, ProgressbarText3,
                          ProgressbarTextBase, ProgressbarZMQClient,
                          ProgressbarZMQServer, center_message)
