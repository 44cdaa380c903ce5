"""``chip_smoke.py``'s phase 6 rehearsed on the CPU at a small size.

- The model directory the smoke writes holds a tokenizer that HF
  ``tokenizers`` reads as the port does: equal ids and text.
- ``chip_smoke.http_path`` (the HTTP entry point, two bursts, chats, a
  unary request, a stop string, a lone request against a direct
  engine) runs to its end with TINY widths on the CPU, and its burst's
  text equals the phase-5-style direct engine's tokens decoded.
"""

import json
from dataclasses import replace

import numpy as np
import pytest
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch import tokenizer as tokmod
from dynamo_exp_tpu_torch.models import TINY
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

SMALL = replace(TINY, vocab_size=2048, max_position_embeddings=512)


@pytest.fixture(scope="module")
def readme():
    with open(f"{cs.HERE}/README.md", encoding="utf-8") as f:
        return f.read()


def test_smoke_model_dir_tokenizer_matches_hf(tmp_path, readme):
    import tokenizers

    d = cs.write_model_dir(str(tmp_path / "m"), tokmod, SMALL, readme)
    hf = tokenizers.Tokenizer.from_file(f"{d}/tokenizer.json")
    tok = tokmod.Tokenizer.from_pretrained(d)
    assert hf.get_vocab_size() == tok.vocab_size == SMALL.vocab_size
    assert pkg.models.ModelConfig.from_pretrained(d) == SMALL
    with open(f"{d}/generation_config.json") as f:
        assert tok.eos_token_ids == [json.load(f)["eos_token_id"]] == [2048 - 256 + 9]
    for text in (readme[:2000], *[m["content"] for c in cs.CHATS for m in c],
                 "<|begin_of_text|>hi<|eot_id|>"):
        for special in (True, False):
            assert tok.encode(text, special).ids == hf.encode(
                text, add_special_tokens=special).ids
    rs = np.random.RandomState(0)
    replaced = 0
    for _ in range(100):
        ids = [int(i) for i in rs.randint(0, SMALL.vocab_size, size=24)]
        assert tok.decode(ids) == hf.decode(ids)
        replaced += "�" in hf.decode(ids)
    assert replaced  # random ids split characters


def test_smoke_http_phase_on_cpu():
    lens, max_tokens = (5, 20, 40, 33), 6
    max_len = max(lens) + max_tokens + cs.PS
    ecfg = pkg.engine.EngineConfig(
        model=SMALL, max_decode_slots=8, page_size=cs.PS, max_model_len=max_len,
        num_pages=8 * -(-max_len // cs.PS), kv_dtype="bfloat16",
    )
    requests = [
        {"token_ids": ids, "stop_conditions": {"max_tokens": max_tokens, "ignore_eos": True},
         "sampling_options": cs.SEEDED_OPTIONS if i == 1 else {}}
        for i, ids in enumerate(cs.phase5_prompts(np, SMALL.vocab_size, lens))
    ]
    out, _ = cs.run_engine(pkg.engine.TorchEngine(ecfg, device="cpu"), requests)
    stats = cs.http_path(torch, np, pkg, tra, [t for t, _, _ in out], device="cpu",
                         mcfg=SMALL, prompt_lens=lens, max_tokens=max_tokens, seeded=1)
    assert stats["same_as_phase5"] == [True] * len(lens)
    assert stats["a"]["completion_tokens"] == len(lens) * max_tokens
    assert stats["a"]["frames"] > 0 and stats["encode_tokens"] > 0
