"""Progress display (layer: observability)."""

from .progressbar import (DummyProgressbar, ProgressBarBase,  # noqa: F401
                          ProgressbarDistributedClientBase,
                          ProgressbarDistributedServerBase,
                          ProgressbarMultiProcessClient,
                          ProgressbarMultiProcessServer, ProgressbarText,
                          ProgressbarText2, ProgressbarText3,
                          ProgressbarTextBase, center_message)
