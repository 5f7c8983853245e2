"""Distribution layer: complex directional densities + EM trainers
(counterpart of ``pb_bss_tpu.models``; also importable as
``pb_bss_tpu_torch.distribution``)."""
from .base import (  # noqa: F401
    Model,
    modelclass,
    parameter_from_dict,
    get_trainer_class_from_model,
    stack_parameters,
    force_hermitian,
)
from .complex_circular_symmetric_gaussian import (  # noqa: F401
    ComplexCircularSymmetricGaussian,
    ComplexCircularSymmetricGaussianTrainer,
)
from .complex_angular_central_gaussian import (  # noqa: F401
    ComplexAngularCentralGaussian,
    ComplexAngularCentralGaussianTrainer,
    normalize_observation,
    sample_complex_angular_central_gaussian,
)
from .cacgmm import CACGMM, CACGMMTrainer, sample_cacgmm  # noqa: F401
from .cacgmm_streaming import (  # noqa: F401
    StreamingCACGMM,
    StreamingCACGMMState,
)
from .gaussian import (  # noqa: F401
    Gaussian,
    DiagonalGaussian,
    SphericalGaussian,
    GaussianTrainer,
)
from .gmm import GMM, GMMTrainer, BinaryGMM, BinaryGMMTrainer  # noqa: F401
from .von_mises_fisher import (  # noqa: F401
    VonMisesFisher,
    VonMisesFisherTrainer,
)
from .vmfmm import VMFMM, VMFMMTrainer  # noqa: F401
from .complex_watson import ComplexWatson, ComplexWatsonTrainer  # noqa: F401
from .cwmm import CWMM, CWMMTrainer  # noqa: F401
from .complex_bingham import (  # noqa: F401
    ComplexBingham,
    ComplexBinghamTrainer,
)
from .cbmm import CBMM, CBMMTrainer  # noqa: F401
from .gcacgmm import GCACGMM, GCACGMMTrainer  # noqa: F401
from .vmfcacgmm import VMFCACGMM, VMFCACGMMTrainer  # noqa: F401
from .fca import FCA, FCATrainer  # noqa: F401
from . import mixture_model_utils  # noqa: F401
from .mixture_model_utils import (  # noqa: F401
    estimate_mixture_weight,
    log_pdf_to_affiliation,
)

# the reference's module name for the model base and serialization
# helpers (``pb_bss.distribution.utils``)
from . import base as utils  # noqa: F401
