from holoscene_tpu_torch.physics.sim import (
    StabilityResult,
    get_provider,
    provider_report,
    settle_drop,
    sim_scene,
    sim_validation,
)
