"""Broadcasting policies.  Importing this package registers the built-in
policy kinds (Poisson, Hawkes, piecewise, RealData, Opt and the RMTPP
neural policy) with the registry in :mod:`.base`."""

from . import base  # noqa: F401
from . import poisson  # noqa: F401
from . import hawkes  # noqa: F401
from . import piecewise  # noqa: F401
from . import realdata  # noqa: F401
from . import opt  # noqa: F401
from . import rmtpp  # noqa: F401
