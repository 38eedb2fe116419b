"""The installation stage (paper §4.1): profile the dictionary families on
the device, fit Δ, store it per device (the twin of ``repro.costmodel``);
``moe_profile`` does the same for the MoE layers' dispatch choice."""
from .moe_profile import DispatchModel, install_dispatch, load_dispatch_model, profile_dispatch  # noqa: F401
from .profiler import ProfileRow, ProfileTable, profile, profile_quick  # noqa: F401
from .regression import MODEL_ZOO, make, with_log_features  # noqa: F401
from .store import (  # noqa: F401
    AllInOneCostModel,
    LearnedCostModel,
    default_dir,
    install,
    load_model,
    load_profile,
    save_model,
    train,
    train_all_in_one,
)
