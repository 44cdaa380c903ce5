from .common import (
    BackendInput,
    FinishReason,
    LLMEngineOutput,
    SamplingOptions,
    StopConditions,
)

__all__ = [
    "BackendInput",
    "FinishReason",
    "LLMEngineOutput",
    "SamplingOptions",
    "StopConditions",
]
