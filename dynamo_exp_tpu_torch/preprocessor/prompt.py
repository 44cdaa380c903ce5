"""Chat-template rendering (Jinja) for prompt formatting.

Counterpart of ``dynamo_exp_tpu/preprocessor/prompt.py``: render
``tokenizer_config.json`` chat templates in jinja2's immutable sandbox,
with the helpers HF templates expect (``raise_exception``, ``tojson``,
``strftime_now``), and a neutral role-tagged fallback without one.
"""

from __future__ import annotations

import datetime
import json
from typing import Any

import jinja2
from jinja2.sandbox import ImmutableSandboxedEnvironment

from ..model_card import ModelDeploymentCard


class PromptFormatError(ValueError):
    pass


def _raise_exception(message: str) -> None:
    raise PromptFormatError(message)


def _strftime_now(fmt: str) -> str:
    return datetime.datetime.now().strftime(fmt)


class PromptFormatter:
    """Renders OpenAI-style message lists into a single prompt string."""

    def __init__(self, mdc: ModelDeploymentCard):
        self.mdc = mdc
        self._env = ImmutableSandboxedEnvironment(
            trim_blocks=True,
            lstrip_blocks=True,
            keep_trailing_newline=True,
            undefined=jinja2.ChainableUndefined,
        )
        self._env.globals["raise_exception"] = _raise_exception
        self._env.globals["strftime_now"] = _strftime_now
        self._env.filters["tojson"] = lambda v, **kw: json.dumps(v, **kw)
        self._template = (
            self._env.from_string(mdc.chat_template) if mdc.chat_template else None
        )

    def render(
        self,
        messages: list[dict[str, Any]],
        tools: list[dict[str, Any]] | None = None,
    ) -> str:
        if self._template is None:
            return self._fallback(messages)
        try:
            return self._template.render(
                messages=messages,
                tools=tools,
                add_generation_prompt=True,
                bos_token=self.mdc.bos_token or "",
                eos_token=self.mdc.eos_token or "",
            )
        except PromptFormatError:
            raise
        except jinja2.TemplateError as e:
            raise PromptFormatError(f"chat template failed: {e}") from e

    @staticmethod
    def _fallback(messages: list[dict[str, Any]]) -> str:
        """No template in the card: a neutral role-tagged concatenation."""
        parts = []
        for m in messages:
            content = m.get("content") or ""
            if isinstance(content, list):
                content = "".join(
                    p.get("text", "") for p in content if isinstance(p, dict)
                )
            parts.append(f"{m.get('role', 'user')}: {content}")
        parts.append("assistant:")
        return "\n".join(parts)
