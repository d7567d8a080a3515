from tpumix_torch.models.scalar import (  # noqa: F401
    MixingModelScalar1s,
    MixingModelScalar1sL,
    MixingModelScalar2s,
    MixingModelScalar2sL,
)
