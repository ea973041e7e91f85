from .engines import (BGColorizeEngine, FGColorizeEngine, MatchingEngine,
                      PIXEL_MU)
from .session import ColorizationSession
from .factory import build_session
from . import compositing
