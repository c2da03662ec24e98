"""Interference alignment: the host solvers (numpy, over
``channels.MultiUserChannelMatrix``) and the batched fixed-iteration
solvers (:mod:`.batched`, torch)."""

from .algorithms import (AlternatingMinIASolver,  # noqa: F401
                         BruteForceStreamIASolver, ClosedFormIASolver,
                         GreedStreamIASolver, IterativeIASolverBaseClass,
                         MaxSinrIASolver, MinLeakageIASolver, MMSEIASolver)
from .iabase import IASolverBaseClass  # noqa: F401
