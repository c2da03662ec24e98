"""Progress display (layer: observability)."""

from .progressbar import (DummyProgressbar, ProgressBarBase,  # noqa: F401
                          ProgressbarText, ProgressbarText2,
                          ProgressbarText3, ProgressbarTextBase,
                          center_message)
