"""``chip_smoke.py``'s phase 14 rehearsed on the CPU at a small size: a
gemma2 config at TINY-like widths (a vocabulary of 2,048, head dim 32, a
32-token window on even layers, both softcaps) through (a) the engine,
8 requests admitted together (two prompts past the window), a rerun
token-identical; (b) plain against kernel at 4 layers, also a windowed
mistral; (c) ``run.main_async(in=http out=cuda --device cpu)`` on a
model directory with a SentencePiece-BPE tokenizer and Gemma's chat
template: 8 streaming chats (one past the window), usage exact, and a
lone request's HTTP text equal to a direct engine's tokens. On the CPU
the kernel wrappers compute their plain versions, so (b) compares the
plain path with itself through both entry points' wrappers."""

from dataclasses import replace

import numpy as np
import torch

import chip_smoke as cs
import dynamo_exp_tpu_torch as pkg
import dynamo_exp_tpu_torch.engine  # noqa: F401
from dynamo_exp_tpu_torch.models import GEMMA2_9B, MISTRAL_7B
from dynamo_exp_tpu_torch.ops import ragged_attention as tra

_SMALL = dict(vocab_size=2048, hidden_size=64, intermediate_size=128, num_layers=4,
              num_heads=4, num_kv_heads=2, head_dim=32, sliding_window=32,
              max_position_embeddings=512)
GEMMA2 = replace(GEMMA2_9B, **_SMALL, attn_logit_softcap=5.0, final_logit_softcap=3.0,
                 query_pre_attn_scalar=24.0)
MISTRAL = replace(MISTRAL_7B, **_SMALL)


def test_smoke_phase14_on_cpu():
    sh = cs.Phase14(device="cpu", long_lens=(40, 56), short_lens=(8, 12, 16, 20, 24, 30),
                    max_tokens=8, check_layers=4, check_len=48, long_chat_chars=600)
    out = cs.phase14(torch, np, pkg, tra, "cpu", sh=sh, mcfg=GEMMA2,
                     check_cfgs=(GEMMA2, MISTRAL))
    a, b, c = out["a"], out["b"], out["c"]
    assert a["completion_tokens"] == 8 * sh.max_tokens
    assert set(b) == {"gemma2", "mistral"}
    assert all(r["max_abs_err"] == 0.0 and r["argmax_agreement"] == 1.0 for r in b.values())
    assert max(c["prompt_tokens"]) > GEMMA2.sliding_window
    assert len(c["finishes"]) == 8


def test_sp_tokenizer_spec_reads_back_in_both_packages(tmp_path):
    """The smoke's Gemma-layout tokenizer: the port and ``tokenizers``
    give the same ids, and text with CJK falls back to byte tokens."""
    import json

    from dynamo_exp_tpu.tokenizer import Tokenizer as JTokenizer
    from dynamo_exp_tpu_torch.tokenizer import Tokenizer

    with open(cs.os.path.join(cs.HERE, "README.md"), encoding="utf-8") as f:
        text = f.read()
    spec = cs.sp_tokenizer_spec(4096, text)
    assert len(spec["model"]["vocab"]) == 4096
    (tmp_path / "tokenizer.json").write_text(json.dumps(spec, ensure_ascii=False))
    jtok, tok = JTokenizer.from_pretrained(str(tmp_path)), Tokenizer.from_pretrained(
        str(tmp_path))
    for s in (text[:3000], " doubled  spaces ", "日本語 ☃🎉", "<start_of_turn>user\nhi"):
        assert tok.encode(s).ids == jtok.encode(s).ids, s
    assert any(t.startswith("<0x") for t in jtok.encode("日本語").tokens)
