from .schema import (
    AttenuationModel,
    ConfigError,
    FilterType,
    HrtfConfig,
    OutputMode,
    RenderConfig,
    Speaker,
    load_config,
    parse_config,
)
