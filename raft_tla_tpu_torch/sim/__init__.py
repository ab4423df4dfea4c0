"""Random-walk simulation engine (TLC ``-simulate`` analogue).

``SimEngine`` runs W walkers on one device; see sim/walker.py for the
design notes.
"""

from .walker import SimEngine, SimResult, WalkerHit  # noqa: F401
