from .activation import *  # noqa: F401,F403
from .common import *  # noqa: F401,F403
from .norm import *  # noqa: F401,F403
from .loss import *  # noqa: F401,F403
from .attention import *  # noqa: F401,F403
from .attention import ROUTE_COUNTS, reset_route_counts  # noqa: F401

from . import activation, attention, common, loss, norm  # noqa: F401
