from .base import Model  # noqa: F401
from .cacgmm import CACGMM, CACGMMTrainer  # noqa: F401
from .cbmm import CBMM, CBMMTrainer  # noqa: F401
from .complex_bingham import (  # noqa: F401
    ComplexBingham,
    ComplexBinghamTrainer,
)
from .complex_angular_central_gaussian import (  # noqa: F401
    ComplexAngularCentralGaussian,
    ComplexAngularCentralGaussianTrainer,
)
from .complex_watson import ComplexWatson, ComplexWatsonTrainer  # noqa: F401
from .cwmm import CWMM, CWMMTrainer  # noqa: F401
from .fca import FCA, FCATrainer  # noqa: F401
from .gaussian import (  # noqa: F401
    DiagonalGaussian,
    Gaussian,
    GaussianTrainer,
    SphericalGaussian,
)
from .gcacgmm import GCACGMM, GCACGMMTrainer  # noqa: F401
from .vmfcacgmm import VMFCACGMM, VMFCACGMMTrainer  # noqa: F401
from .von_mises_fisher import (  # noqa: F401
    VonMisesFisher,
    VonMisesFisherTrainer,
)
