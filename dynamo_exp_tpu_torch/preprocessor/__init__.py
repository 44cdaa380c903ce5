from .preprocessor import InvalidRequestError, OpenAIPreprocessor, PromptTooLongError
from .prompt import PromptFormatError, PromptFormatter

__all__ = [
    "InvalidRequestError",
    "OpenAIPreprocessor",
    "PromptFormatError",
    "PromptFormatter",
    "PromptTooLongError",
]
