"""GPT-2 style causal LM: the forward, the pretraining loss and KV-cache
``generate``.

Ports paddle_tpu/models/gpt.py: ``GPTConfig``, ``GPTAttention`` (GQA and
sliding window), ``GPTMLP``, ``GPTBlock`` with its ``_tpp_mlp`` hook,
``GPTModel``, ``GPTForCausalLM`` with the tied head ``h @ wte^T`` and its
``loss``, ``GPTPretrainLoss``, the decode path (``_decode_fns``,
``_check_decode_config``, ``_decode_compute_dtype``, ``_decode_setup``,
``_gpt_generate`` with left-padded ragged prompts, ``_gpt_beam_search``,
``_gpt_speculative``), and ``GPTDecodeModel``, the family's adapter for
the serving engine with its multi-LoRA factors (``lora_init``,
``lora_pack``), registered at import.

The forward is differentiable on every path: the flash and TPP kernels sit
in autograd Functions whose backward is a kernel (flash) or the
reference's plain math (TPP). Dropout (``model.train()`` with
``dropout > 0``) draws its masks from a ``torch.Generator`` (the default
generator of the activations' device), never from torch's global RNG.

Attention goes through ``scaled_dot_product_attention``, which sends a
CUDA tensor at seq >= 1024 to the flash kernel; with FLAGS_tpp_kernels set
each block's ln2 + MLP goes through the TPP matmul kernel. The decode path
runs no kernel of its own, as in the reference: its attention is a plain
einsum over the cache. It computes in the dtype its params and cache hold
(fp32, or bf16 with ``dtype="bfloat16"``) whatever ``amp.auto_cast``
says, as the reference's raw ``jnp`` decode math does. The reference
compiles generate as one jit(scan); here it is an eager loop over the new
tokens against a pre-allocated cache that is updated in place.

Linear layers are the port's ``nn.Linear``, a ``torch.nn.Linear`` (weight
[out, in]; the reference's stores [in, out], which ``models/convert.py``
transposes) whose forward reads ``amp.auto_cast`` as the reference's
does; so does the tied head, ``tensor.matmul(h, wte, transpose_y=True)``.
Parameter names are the reference's (``gpt.blocks.{i}.attn.qkv.weight``,
...). Tensor-parallel, MoE and sequence-parallel configurations are not
ported yet and are refused by ``GPTConfig``.
"""
import math
import operator
import re

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .. import flags as _flags
from ..amp.auto_cast import disabled as _autocast_off
from ..core import generator as _generator
from ..core.device import resolve_device
from ..nn.functional.common import dropout as _dropout
from ..nn.functional.loss import cross_entropy
from ..nn.functional.transformer import scaled_dot_product_attention
from ..nn.layer.common import Linear
from ..ops import tpp
from ..serving import decode_model as _decode_model
from ..serving.decode_model import cache_leaves, cache_map, cast_params
from ..tensor.math import matmul


class GPTConfig:
    def __init__(self, vocab_size=50304, hidden_size=768, num_layers=12,
                 num_heads=12, max_seq_len=1024, intermediate_size=None,
                 dropout=0.1, tensor_parallel=False, use_flash=True,
                 num_experts=0, sequence_parallel=False, gelu_approx=False,
                 attention_window=None, num_kv_heads=None):
        if tensor_parallel:
            raise ValueError("tensor_parallel=True is not ported yet: the "
                             "port serves dense single-device models")
        if num_experts > 0:
            raise ValueError("num_experts > 0 (MoE) is not ported yet")
        if sequence_parallel:
            raise ValueError("sequence_parallel=True is not ported yet")
        self.vocab_size = vocab_size
        self.hidden_size = hidden_size
        self.num_layers = num_layers
        self.num_heads = num_heads
        self.max_seq_len = max_seq_len
        self.intermediate_size = intermediate_size or 4 * hidden_size
        self.dropout = dropout
        self.tensor_parallel = False
        self.num_experts = 0
        self.sequence_parallel = False
        self.use_flash = use_flash
        # tanh-approximate gelu (HF GPT-2's gelu_new); False = exact erf
        self.gelu_approx = gelu_approx
        # sliding-window causal attention: the forward and the decode
        # attend only to the last W tokens
        if attention_window is not None:
            if isinstance(attention_window, bool):
                raise ValueError(f"attention_window must be a positive int, "
                                 f"got {attention_window!r}")
            try:
                attention_window = int(operator.index(attention_window))
            except TypeError:
                raise ValueError(
                    f"attention_window must be a positive int, got "
                    f"{attention_window!r}") from None
            if attention_window < 1:
                raise ValueError(f"attention_window must be a positive int, "
                                 f"got {attention_window!r}")
        self.attention_window = attention_window
        # grouped-query attention: num_kv_heads < num_heads shares each K/V
        # head across a group of query heads (the cache keeps the compact
        # heads)
        num_kv_heads = num_kv_heads if num_kv_heads is not None else num_heads
        if (isinstance(num_kv_heads, bool)
                or not (1 <= num_kv_heads <= num_heads)
                or num_heads % num_kv_heads != 0):
            raise ValueError(
                f"num_kv_heads ({num_kv_heads!r}) must divide num_heads "
                f"({num_heads}) and lie in [1, num_heads]")
        self.num_kv_heads = num_kv_heads

    @staticmethod
    def small():
        return GPTConfig(hidden_size=768, num_layers=12, num_heads=12)

    @staticmethod
    def tiny():  # tests
        return GPTConfig(vocab_size=1024, hidden_size=64, num_layers=2,
                         num_heads=4, max_seq_len=128, dropout=0.0)


class Dropout(nn.Module):
    """nn.Dropout drawing its mask from a torch.Generator (the reference's
    ``nn.Dropout``: upscale_in_train, identity in eval mode)."""

    def __init__(self, p):
        super().__init__()
        self.p = p

    def forward(self, x):
        return _dropout(x, self.p, training=self.training)


class GPTAttention(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h = cfg.hidden_size
        self.num_heads = cfg.num_heads
        self.head_dim = h // cfg.num_heads
        self.num_kv_heads = cfg.num_kv_heads
        qkv_out = (self.num_heads + 2 * self.num_kv_heads) * self.head_dim
        self.use_flash = cfg.use_flash
        self.window = cfg.attention_window
        self.qkv = Linear(h, qkv_out)
        self.proj = Linear(h, h)
        self.dropout = cfg.dropout

    def forward(self, x):
        b, s, h = x.shape
        H, K, hd = self.num_heads, self.num_kv_heads, self.head_dim
        # boundary split [q | k | v]: the (3, H, hd) unpacking when K == H
        q, k, v = self.qkv(x).split([H * hd, K * hd, K * hd], dim=-1)
        q = q.reshape(b, s, H, hd)
        k = k.reshape(b, s, K, hd)
        v = v.reshape(b, s, K, hd)
        if K != H:
            # expand the shared K/V heads over their query groups
            k = k.repeat_interleave(H // K, dim=2)
            v = v.repeat_interleave(H // K, dim=2)
        out = scaled_dot_product_attention(
            q, k, v, is_causal=True,
            dropout_p=self.dropout if self.training else 0.0,
            training=self.training, use_flash=self.use_flash,
            window=self.window)
        return self.proj(out.reshape(b, s, h))


class GPTMLP(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        h, i = cfg.hidden_size, cfg.intermediate_size
        self.fc1 = Linear(h, i)
        self.fc2 = Linear(i, h)
        self._gelu_approx = cfg.gelu_approx

    def forward(self, x):
        return self.fc2(F.gelu(self.fc1(x), approximate=(
            "tanh" if self._gelu_approx else "none")))


class GPTBlock(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.ln1 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.attn = GPTAttention(cfg)
        self.ln2 = nn.LayerNorm(cfg.hidden_size, eps=1e-5)
        self.mlp = GPTMLP(cfg)
        self.drop = Dropout(cfg.dropout)

    def forward(self, x):
        x = x + self.drop(self.attn(self.ln1(x)))
        y = self._tpp_mlp(x)
        if y is None:
            y = self.mlp(self.ln2(x))
        return x + self.drop(y)

    def _tpp_mlp(self, x):
        """FLAGS_tpp_kernels: route ln2 + MLP through the TPP kernel's two
        ported ops (ln_matmul feeding the fused gelu + projection tail).
        None = the dense path (flag unset, or shapes the kernel's gate
        refuses)."""
        if not _flags.get_flag("tpp_kernels", False):
            return None
        return tpp.gpt_block_mlp(x, self.ln2, self.mlp)


class GPTModel(nn.Module):
    def __init__(self, cfg):
        super().__init__()
        self.cfg = cfg
        self.wte = nn.Embedding(cfg.vocab_size, cfg.hidden_size)
        self.wpe = nn.Embedding(cfg.max_seq_len, cfg.hidden_size)
        self.drop = Dropout(cfg.dropout)
        self.blocks = nn.ModuleList(
            [GPTBlock(cfg) for _ in range(cfg.num_layers)])
        self.ln_f = nn.LayerNorm(cfg.hidden_size, eps=1e-5)

    def forward(self, input_ids):
        s = input_ids.shape[1]
        pos = torch.arange(s, device=input_ids.device)
        x = self.drop(self.wte(input_ids) + self.wpe(pos))
        for blk in self.blocks:
            x = blk(x)
        return self.ln_f(x)


def _init_weights(model, generator):
    """The reference's initializers, drawn from `generator` (a CPU
    torch.Generator, so a seed gives the same weights on every device):
    Xavier-normal Linear weights and embeddings (std sqrt(2 / (fan_in +
    fan_out))), zero biases, LayerNorm weight 1 and bias 0."""
    for mod in model.modules():
        if isinstance(mod, (nn.Linear, nn.Embedding)):
            rows, cols = mod.weight.shape
            std = math.sqrt(2.0 / (rows + cols))
            with torch.no_grad():
                mod.weight.normal_(0.0, std, generator=generator)
            if getattr(mod, "bias", None) is not None:
                nn.init.zeros_(mod.bias)
        elif isinstance(mod, nn.LayerNorm):
            nn.init.ones_(mod.weight)
            nn.init.zeros_(mod.bias)


class GPTForCausalLM(nn.Module):
    """LM head tied to wte. Runs on ``device`` (default ``cuda``; raises
    without a CUDA device unless ``device="cpu"``), with weights drawn
    from ``generator`` (default: the CPU default generator, see
    ``paddle_tpu_torch.seed``)."""

    def __init__(self, cfg, device=None, generator=None):
        super().__init__()
        dev = resolve_device(device)
        self.cfg = cfg
        with torch.device("meta"):
            self.gpt = GPTModel(cfg)
        self.to_empty(device="cpu")
        _init_weights(self, generator or _generator.default_generator("cpu"))
        self.to(dev)

    @property
    def device(self):
        return self.gpt.wte.weight.device

    def forward(self, input_ids):
        h = self.gpt(torch.as_tensor(input_ids, device=self.device))
        # tied head: h @ wte^T
        return matmul(h, self.gpt.wte.weight, transpose_y=True)

    def loss(self, input_ids, labels):
        """Mean hard-label cross-entropy of the logits against `labels`
        [b, s] (no shift: the caller aligns them)."""
        logits = self.forward(input_ids)
        b, s, v = logits.shape
        return cross_entropy(logits.reshape(b * s, v),
                             torch.as_tensor(labels, device=self.device)
                             .reshape(b * s))

    def generate(self, input_ids, max_new_tokens=32, temperature=1.0,
                 top_k=None, top_p=None, seed=None, eos_token_id=None,
                 num_beams=1, length_penalty=1.0, dtype=None,
                 attention_mask=None, cache_dtype=None, tp_mesh=None):
        """Autoregressive decode with a KV cache. temperature=0 decodes
        greedily; otherwise samples (top_k keeps the k highest logits,
        top_p < 1.0 then keeps the smallest prefix reaching mass top_p),
        seeded by `seed` through a torch.Generator on the model's device.
        dtype='bfloat16' serves in bf16 (params and cache; logits pick in
        fp32). cache_dtype='int8' or 'fp8' quantizes the KV cache (one
        fp32 absmax scale a cached row; ``_decode_fns``), and composes with
        dtype. attention_mask [b, prompt] (1 = token, 0 = pad) serves
        LEFT-padded ragged prompts. Returns [b, prompt + max_new_tokens]
        int64 ids, prompt included.

        num_beams > 1 runs beam search (``_gpt_beam_search``) and returns
        a (sequences, scores) pair: the best beam of each row and its
        joint log-prob, length-normalized for the pick by length_penalty;
        top_k / top_p raise there. Tensor-parallel serving (tp_mesh) is
        not ported yet."""
        if tp_mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (tp_mesh=) is not ported yet")
        if num_beams > 1:
            if top_p is not None or top_k is not None:
                raise ValueError(
                    "top_k/top_p are sampling knobs; beam search is "
                    "deterministic: drop them or use num_beams=1")
            return _gpt_beam_search(self, input_ids, max_new_tokens,
                                    num_beams, eos_token_id, length_penalty,
                                    dtype=dtype,
                                    attention_mask=attention_mask,
                                    cache_dtype=cache_dtype)
        return _gpt_generate(self, input_ids, max_new_tokens, temperature,
                             top_k, seed, eos_token_id, dtype=dtype,
                             top_p=top_p, cache_dtype=cache_dtype,
                             attention_mask=attention_mask)

    def generate_speculative(self, draft_model, input_ids,
                             max_new_tokens=32, k=4, dtype=None,
                             cache_dtype=None, tp_mesh=None,
                             eos_token_id=None):
        """Speculative greedy decoding with a small draft model: the
        output of greedy ``generate`` (the acceptance rule is exact) at
        1..k + 1 tokens a target forward. Returns (sequences, n_rounds).
        Batch 1, greedy only (``_gpt_speculative``). tp_mesh is not
        ported yet."""
        if tp_mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving (tp_mesh=) is not ported yet")
        return _gpt_speculative(self, draft_model, input_ids,
                                max_new_tokens, k=k, dtype=dtype,
                                cache_dtype=cache_dtype,
                                eos_token_id=eos_token_id)


class GPTPretrainLoss(nn.Module):
    """loss_fn for SpmdTrainer: logits [b, s, v] and labels [b, s] -> the
    mean cross-entropy over the b * s rows."""

    def forward(self, logits, labels):
        b, s, v = logits.shape
        return cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))


# ---------------------------------------------------------------------------
# Autoregressive decoding with a KV cache (the serving path).
# ---------------------------------------------------------------------------

#: quantized KV-cache formats: (storage dtype, qmax, integer rounding).
#: int8 rounds half to even and clips to +-127; fp8 (e4m3fn, largest
#: finite value 448) casts: the per-row absmax scale puts every value
#: inside its range, and the cast keeps a mantissa
_QUANT = {"int8": (torch.int8, 127.0, True),
          "fp8": (torch.float8_e4m3fn, 448.0, False)}


def _quantize(val, cache_dtype):
    """A cache row's codes and scale in the ``_QUANT`` format: val [...,
    hd] divided by its absmax / qmax (taken in val's dtype, then fp32, at
    least 1e-8) and cast, int8 after rounding half to even and clipping.
    Returns (codes [..., hd], fp32 scales [..., 1])."""
    qdt, qmax, integer = _QUANT[cache_dtype]
    s = torch.clamp_min(val.abs().amax(-1, keepdim=True).float() / qmax,
                        1e-8)
    q = val.float() / s
    if integer:
        q = torch.clamp(torch.round(q), -qmax, qmax)
    return q.to(qdt), s


def _decode_fns(cfg, cache_dtype=None):
    """Plain-PyTorch decode math over name-addressed params (port layout:
    Linear weights [out, in]). Returns (fwd, logits_of, cache_init).
    fwd(p, tok_ids [B, t], pos, kc, vc) runs the block stack with its first
    column at cache column `pos` and writes K/V into the cache
    [L, B, KVh, T, hd] IN PLACE (the reference's dynamic_update_slice
    returns a new array; here the pre-allocated cache is mutated). `pos` is
    an int (the whole batch at one frontier) or a [B] tensor (each row at
    its own frontier: continuous batching). fwd and logits_of run with
    autocast off: they compute in the dtype of their params and cache.

    cache_dtype 'int8' or 'fp8' (``_QUANT``) keeps each cache side as a
    (values, scales) pair: values [L, B, KVh, T, hd] in the storage dtype
    and one fp32 scale a cached row, [L, B, KVh, T, 1]. A stored row is
    quantized by ``_quantize``; a loaded layer is multiplied back in fp32
    and cast to q's dtype. Any other
    cache_dtype raises ValueError, for every entry point.

    fwd's optional arguments, as the reference's:
    - key_valid [B, T] bool: False columns (left padding) are masked out
      of every query; a pad query still sees itself, so no softmax row is
      empty (its lane is garbage no valid query reads);
    - pos_ids [B, t]: per-row position ids (ragged rows); without them the
      positions follow the cache columns;
    - lora, adapter_ids: the stacked multi-LoRA factors of
      ``GPTDecodeModel.lora_init`` ({"scale": [S], kind: {"A": [S, L, din,
      r], "B": [S, L, r, dout]}} for kind in qkv | proj | fc1 | fc2) and
      each row's slot [B]. The rows' factors are gathered once a call;
      each site adds ``(x @ A) @ B * scale`` by one batched product pair.
      Slot 0 is all zeros: a base row adds an exact zero.
    The reference's tensor-parallel heads (tp_axis) are not ported."""
    if cache_dtype is not None and cache_dtype not in _QUANT:
        raise ValueError(f"cache_dtype must be None, 'int8', or 'fp8', "
                         f"got {cache_dtype!r}")
    quant = _QUANT.get(cache_dtype)
    L, Hh = cfg.num_layers, cfg.num_heads
    hd = cfg.hidden_size // Hh
    scale = 1.0 / math.sqrt(hd)
    win = cfg.attention_window
    KVh = cfg.num_kv_heads   # GQA: compact K/V heads
    g = Hh // KVh            # query heads per kv head
    gelu = "tanh" if cfg.gelu_approx else "none"

    def cache_init(b_, T_, dtype, device):
        shape = (L, b_, KVh, T_, hd)
        if quant is None:
            z = torch.zeros(shape, dtype=dtype, device=device)
            return z, torch.zeros_like(z)

        def side():
            return (torch.zeros(shape, dtype=quant[0], device=device),
                    torch.zeros(shape[:-1] + (1,), dtype=torch.float32,
                                device=device))
        return side(), side()

    def ln(x, w, bb):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * w + bb

    def store(c, i, val, pos, per_row):
        """val [B, KVh, t, hd] into layer i of a cache side at column pos
        (per row: row b at its own pos[b]), quantized first for a
        (values, scales) side."""
        if quant is None:
            put(c, i, val, pos, per_row)
            return
        codes, s = _quantize(val, cache_dtype)
        put(c[0], i, codes, pos, per_row)
        put(c[1], i, s, pos, per_row)

    def load(c, i, like):
        """Layer i of a cache side in dtype `like` (dequantized)."""
        if quant is None:
            return c[i]
        return (c[0][i].float() * c[1][i]).to(like)

    def put(c, i, val, pos, per_row):
        t = val.shape[2]
        if not per_row:
            c[i, :, :, pos:pos + t] = val
            return
        # a start past T - t is clamped, as dynamic_update_slice clamps it:
        # a slot finished at "capacity" keeps pos == T until its next
        # admission, and its junk write stays inside its own (freed) row
        T = c.shape[3]
        cols = pos.clamp(max=T - t)[:, None] + torch.arange(
            t, device=pos.device)
        rows = torch.arange(val.shape[0], device=pos.device)[:, None]
        c[i][rows, :, cols] = val.transpose(1, 2)

    def ldelta(lora, xin, kind, i):
        """One site's per-row low-rank delta in xin's dtype (slot 0's
        all-zero factors give an exact zero)."""
        A, Bm = lora[kind]
        d = torch.einsum("bti,bir->btr", xin, A[:, i])
        d = torch.einsum("btr,bro->bto", d, Bm[:, i])
        return (d * lora["_scale"][:, None, None]).to(xin.dtype)

    def block(p, i, x, kc, vc, pos, per_row, key_valid=None, lora=None):
        pre = f"gpt.blocks.{i}."
        bb, t = x.shape[0], x.shape[1]
        T = (kc[0] if quant else kc).shape[3]
        h_in = ln(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"])
        flat = F.linear(h_in, p[pre + "attn.qkv.weight"],
                        p[pre + "attn.qkv.bias"])
        if lora is not None:
            flat = flat + ldelta(lora, h_in, "qkv", i)
        q = flat[..., :Hh * hd].reshape(bb, t, Hh, hd).transpose(1, 2)
        k = flat[..., Hh * hd:(Hh + KVh) * hd].reshape(
            bb, t, KVh, hd).transpose(1, 2)
        v = flat[..., (Hh + KVh) * hd:].reshape(
            bb, t, KVh, hd).transpose(1, 2)
        store(kc, i, k, pos, per_row)      # in place
        store(vc, i, v, pos, per_row)
        # causal over cache columns: query row r (column pos + r) sees
        # cache column c iff c <= pos + r; one mask [1-or-B, t, T] serves
        # a scalar pos and a per-row [B] pos
        pos_b = pos[:, None, None] if per_row else pos
        rows = pos_b + torch.arange(t, device=x.device)[None, :, None]
        cols = torch.arange(T, device=x.device)[None, None, :]
        mask = cols <= rows
        if win is not None:  # sliding window: the forward's band
            mask &= (rows - cols) < win
        if key_valid is not None:
            # pad columns hidden; a query keeps itself (no empty row)
            mask = mask & (key_valid[:, None, :] | (cols == rows))
        if g == 1:
            att = torch.einsum("bhtd,bhTd->bhtT", q,
                               load(kc, i, q.dtype)) * scale
            att = torch.softmax(att.masked_fill(~mask[:, None], -math.inf),
                                dim=-1)
            out = torch.einsum("bhtT,bhTd->bhtd", att,
                               load(vc, i, att.dtype))
        else:
            # grouped queries share their kv head: [B, KVh, g, t, *]
            qg = q.reshape(bb, KVh, g, t, hd)
            att = torch.einsum("bkgtd,bkTd->bkgtT", qg,
                               load(kc, i, q.dtype)) * scale
            att = torch.softmax(
                att.masked_fill(~mask[:, None, None], -math.inf), dim=-1)
            out = torch.einsum("bkgtT,bkTd->bkgtd", att,
                               load(vc, i, att.dtype)).reshape(
                                   bb, Hh, t, hd)
        out = out.transpose(1, 2).reshape(bb, t, Hh * hd)
        proj = F.linear(out, p[pre + "attn.proj.weight"])
        if lora is not None:
            proj = proj + ldelta(lora, out, "proj", i)
        x = x + proj + p[pre + "attn.proj.bias"]
        h2 = ln(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"])
        a1 = F.linear(h2, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"])
        if lora is not None:
            a1 = a1 + ldelta(lora, h2, "fc1", i)
        a1 = F.gelu(a1, approximate=gelu)
        mlp = F.linear(a1, p[pre + "mlp.fc2.weight"])
        if lora is not None:
            mlp = mlp + ldelta(lora, a1, "fc2", i)
        return x + mlp + p[pre + "mlp.fc2.bias"]

    def logits_of(p, x_last):
        with _autocast_off():
            h = ln(x_last, p["gpt.ln_f.weight"], p["gpt.ln_f.bias"])
            return F.linear(h, p["gpt.wte.weight"])

    def fwd(p, tok_ids, pos, kc, vc, key_valid=None, pos_ids=None,
            lora=None, adapter_ids=None):
        t = tok_ids.shape[1]
        wpe = p["gpt.wpe.weight"]
        per_row = torch.is_tensor(pos) and pos.ndim == 1
        with _autocast_off():
            if pos_ids is not None:      # ragged rows: per-row positions
                x = p["gpt.wte.weight"][tok_ids] + wpe[pos_ids]
            elif per_row:
                # per-row positions need per-row pe; an inactive row past
                # the table (pos == T after a capacity finish) reads the
                # last row instead of the reference's NaN fill
                ids = (pos[:, None] + torch.arange(t, device=pos.device)) \
                    .clamp(max=wpe.shape[0] - 1)
                x = p["gpt.wte.weight"][tok_ids] + wpe[ids]
            else:
                x = p["gpt.wte.weight"][tok_ids] + wpe[pos:pos + t]
            lg = None
            if lora is not None:
                # one gather a call hoists every row's factors out of the
                # layer loop: [S, L, din, r] -> [B, L, din, r]
                lg = {"_scale": lora["scale"][adapter_ids]}
                for kind in ("qkv", "proj", "fc1", "fc2"):
                    lg[kind] = (lora[kind]["A"][adapter_ids],
                                lora[kind]["B"][adapter_ids])
            for i in range(L):
                x = block(p, i, x, kc, vc, pos, per_row, key_valid, lg)
        return x

    return fwd, logits_of, cache_init


def _check_decode_config(cfg):
    if cfg.num_experts > 0 or cfg.sequence_parallel or cfg.tensor_parallel:
        raise ValueError(
            "generate() decodes dense single-replica configs; for parallel "
            "variants run the dense copy of the trained weights")


def _decode_compute_dtype(dtype):
    """None = fp32 (exact); 'bfloat16'/'float16' = low-precision serving:
    params and the KV cache cast down; logits always pick in fp32."""
    if dtype is None:
        return None
    d = dtype if isinstance(dtype, torch.dtype) else \
        getattr(torch, str(dtype), None)
    if not isinstance(d, torch.dtype) or not d.is_floating_point:
        raise ValueError(f"generate dtype must be floating, got {dtype!r}")
    if d == torch.float32:
        return None
    return d


def _decode_setup(model, input_ids, max_new_tokens):
    cfg = model.cfg
    _check_decode_config(cfg)
    ids = torch.as_tensor(input_ids, device=model.device).long()
    b, s0 = ids.shape
    if max_new_tokens < 1:
        raise ValueError(f"max_new_tokens must be >= 1, got {max_new_tokens}")
    T = s0 + max_new_tokens
    if T > cfg.max_seq_len:
        raise ValueError(f"prompt {s0} + max_new_tokens {max_new_tokens} "
                         f"exceeds max_seq_len {cfg.max_seq_len}")
    return cfg, ids, b, s0, T, _decode_params(model, "the model")


def _decode_params(model, who):
    """The name-addressed param snapshot the decode math reads, refusing a
    model with un-merged LoRA adapters (their factors would be ignored)."""
    params = {n: p.detach() for n, p in model.named_parameters()}
    if any(".lora_A" in n for n in params):
        raise ValueError(
            f"decoding reads name-addressed params and {who} has un-merged "
            "LoRA adapters: call paddle_tpu_torch.incubate.lora.merge_lora "
            "on it before generating, or use the eager forward for sampling "
            "during fine-tuning")
    return params


def _left_pad_mask(attention_mask, b, s0, device):
    """Validate a [b, s0] keep-mask for ragged decode and return it as an
    int64 tensor on `device` (None stays None). Rows must be LEFT-padded
    (zeros then ones) so the last column is every row's final real token,
    the position the next-token logits read."""
    if attention_mask is None:
        return None
    host = attention_mask.detach().cpu().numpy() \
        if torch.is_tensor(attention_mask) else np.asarray(attention_mask)
    if host.shape != (b, s0):
        raise ValueError(f"attention_mask shape {tuple(host.shape)} != "
                         f"{(b, s0)}")
    host = host.astype(np.int64)
    if not np.isin(host, (0, 1)).all():
        raise ValueError("attention_mask must be binary (0 = pad, 1 = "
                         "attend); got other values")
    if not (np.diff(host, axis=1) >= 0).all():
        raise ValueError(
            "attention_mask must be LEFT-padded (0s then 1s per row): "
            "right-padded prompts would put pad tokens at the positions "
            "the decode reads; re-pad with the prompt at the END")
    if not host.any(axis=1).all():
        raise ValueError("attention_mask has an all-pad row")
    return torch.as_tensor(host, device=device)


def _ragged_setup(mask, b, s0, T):
    """Per-row real lengths [b], the [b, T] key-validity mask (generated
    columns always valid) and the prefill position ids [b, s0] of
    LEFT-padded prompts (pad positions clamp to 0); all None without a
    mask."""
    if mask is None:
        return None, None, None
    lens = mask.sum(1)
    key_valid = torch.cat([mask.bool(), torch.ones(
        (b, T - s0), dtype=torch.bool, device=mask.device)], dim=1)
    pos_ids = (torch.arange(s0, device=mask.device)[None, :]
               - (s0 - lens)[:, None]).clamp_min(0)
    return lens, key_valid, pos_ids


def _gpt_generate(model, input_ids, max_new_tokens, temperature, top_k,
                  seed, eos_token_id, dtype=None, top_p=None,
                  cache_dtype=None, attention_mask=None):
    """Prefill, then one step per new token against a cache of static
    shape [L, b, KVh, prompt + max_new_tokens, hd] (parity against the
    cache-free forward is what tests/test_torch_gpt.py pins). With a
    left-padded attention_mask every row keeps its own positions and the
    pad columns stay hidden from the prefill and every step."""
    cfg, ids, b, s0, T, p = _decode_setup(model, input_ids, max_new_tokens)
    fwd, logits_of, cache_init = _decode_fns(cfg, cache_dtype)
    compute_dtype = _decode_compute_dtype(dtype)
    mask = _left_pad_mask(attention_mask, b, s0, ids.device)
    # serving precision: bf16 params + bf16 KV cache; logits in fp32
    p = cast_params(p, compute_dtype)
    if temperature == 0.0:
        gen = None        # greedy never samples: no generator advances
    elif seed is not None:
        gen = torch.Generator(device=ids.device).manual_seed(int(seed))
    else:
        gen = _generator.default_generator(ids.device)

    def pick(logits):
        if temperature == 0.0:
            return torch.argmax(logits, -1)
        lg = logits / temperature
        if top_k is not None and top_k > 0:
            kth = torch.topk(lg, top_k, dim=-1).values[:, -1:]
            lg = lg.masked_fill(lg < kth, -math.inf)
        if top_p is not None and top_p < 1.0:
            # nucleus: keep the smallest prefix of the sorted distribution
            # whose mass reaches top_p (the top token always survives)
            srt = torch.sort(lg, dim=-1, descending=True).values
            probs = torch.softmax(srt, dim=-1)
            cum = torch.cumsum(probs, dim=-1)
            k_keep = ((cum - probs) < top_p).sum(-1)
            cutoff = srt.gather(-1, (k_keep - 1).clamp_min(0)[:, None])
            lg = lg.masked_fill(lg < cutoff, -math.inf)
        return torch.multinomial(torch.softmax(lg, dim=-1), 1,
                                 generator=gen).squeeze(-1)

    with torch.no_grad():
        kc, vc = cache_init(b, T, p["gpt.wte.weight"].dtype, ids.device)
        lens, key_valid, pos_ids = _ragged_setup(mask, b, s0, T)
        x = fwd(p, ids, 0, kc, vc, key_valid=key_valid, pos_ids=pos_ids)
        tok = pick(logits_of(p, x[:, -1]).float())
        done = None if eos_token_id is None else tok == eos_token_id
        toks = [tok]
        for i in range(1, max_new_tokens):
            # the fed token is the (i-1)-th generated one: cache column
            # s0 + i - 1; its position id is per row (len + i - 1) when
            # the batch is ragged
            step_pos = None if lens is None else (lens + (i - 1))[:, None]
            x = fwd(p, tok[:, None], s0 + i - 1, kc, vc,
                    key_valid=key_valid, pos_ids=step_pos)
            tok = pick(logits_of(p, x[:, 0]).float())
            if done is not None:
                tok = torch.where(done, torch.full_like(tok, eos_token_id),
                                  tok)
                done = done | (tok == eos_token_id)
            toks.append(tok)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)


def _gpt_beam_search(model, input_ids, max_new_tokens, num_beams,
                     eos_token_id, length_penalty, dtype=None,
                     attention_mask=None, cache_dtype=None):
    """Beam search over the same decode math: prefill once at batch b,
    tile the cache per beam ([L, b*K, KVh, T, hd], batch-major), then
    each step (a) adds log-probs, (b) takes the joint top-K over K*V
    continuations, (c) reorders the cache by surviving parent beam and
    (d) records (token, parent) for the backtrace. Finished beams (eos)
    only continue with eos at zero added log-prob. The final pick
    normalizes each beam's score by its generated length **
    length_penalty. Returns (sequences [b, prompt + max_new_tokens],
    scores [b]: the picked beam's joint log-prob).

    The cache reorder gathers into a second buffer of the same shape and
    swaps the two, so no step allocates a cache."""
    cfg, ids, b, s0, T, p = _decode_setup(model, input_ids, max_new_tokens)
    if num_beams < 2:
        raise ValueError("num_beams must be >= 2 for beam search")
    if num_beams > cfg.vocab_size:
        raise ValueError(f"num_beams ({num_beams}) cannot exceed "
                         f"vocab_size ({cfg.vocab_size})")
    K, V = int(num_beams), cfg.vocab_size
    fwd, logits_of, cache_init = _decode_fns(cfg, cache_dtype)
    eos = -1 if eos_token_id is None else int(eos_token_id)
    compute_dtype = _decode_compute_dtype(dtype)
    mask = _left_pad_mask(attention_mask, b, s0, ids.device)
    # a bf16 cache matters most here: the cache is K times larger
    p = cast_params(p, compute_dtype)
    dev = ids.device
    with torch.no_grad():
        kc, vc = cache_init(b, T, p["gpt.wte.weight"].dtype, dev)
        lens, key_valid, pos_ids = _ragged_setup(mask, b, s0, T)
        x = fwd(p, ids, 0, kc, vc, key_valid=key_valid, pos_ids=pos_ids)
        logp0 = torch.log_softmax(logits_of(p, x[:, -1]).float(), -1)
        scores, tok = torch.topk(logp0, K, dim=-1)               # [b, K]
        if max_new_tokens == 1:
            best = scores.argmax(-1, keepdim=True)
            seq = tok.gather(1, best)
            return (torch.cat([ids, seq], dim=1),
                    scores.gather(1, best)[:, 0])
        done = tok == eos
        # tile the cache per beam: [b*K] = (b0k0, b0k1, ...); the second
        # buffer receives each step's reorder
        kc = cache_map(lambda a: a.repeat_interleave(K, dim=1), kc)
        vc = cache_map(lambda a: a.repeat_interleave(K, dim=1), vc)
        kc2, vc2 = cache_map(torch.empty_like, kc), \
            cache_map(torch.empty_like, vc)
        kv_beam = None if key_valid is None else \
            key_valid.repeat_interleave(K, dim=0)                # [b*K, T]
        lens_beam = None if lens is None else lens.repeat_interleave(K)
        batch_base = (torch.arange(b, device=dev) * K)[:, None]  # [b, 1]
        gen_len = torch.ones_like(scores)
        frozen = None
        if eos >= 0:
            frozen = torch.full((V,), -math.inf, device=dev)
            frozen[eos] = 0.0
        init_tok = tok
        toks, parents = [], []
        for i in range(1, max_new_tokens):
            step_pos = None if lens_beam is None else \
                (lens_beam + (i - 1))[:, None]
            x = fwd(p, tok.reshape(b * K, 1), s0 + i - 1, kc, vc,
                    key_valid=kv_beam, pos_ids=step_pos)
            logp = torch.log_softmax(logits_of(p, x[:, 0]).float(),
                                     -1).reshape(b, K, V)
            if frozen is not None:   # finished beams: only eos, at no cost
                logp = torch.where(done[:, :, None], frozen, logp)
            total = scores[:, :, None] + logp                    # [b, K, V]
            scores, sel = torch.topk(total.reshape(b, K * V), K, dim=-1)
            parent = sel // V                                    # [b, K]
            tok = sel % V
            if eos >= 0:
                parent_done = done.gather(1, parent)
                # a finished beam keeps its length; a live one grows to
                # i + 1 tokens
                gen_len = torch.where(parent_done, gen_len.gather(1, parent),
                                      torch.full_like(gen_len, i + 1.0))
                done = parent_done | (tok == eos)
            else:
                gen_len = gen_len + 1.0
            rows = (batch_base + parent).reshape(-1)             # [b*K]
            for src, dst in zip(cache_leaves(kc) + cache_leaves(vc),
                                cache_leaves(kc2) + cache_leaves(vc2)):
                torch.index_select(src, 1, rows, out=dst)
            kc, kc2 = kc2, kc
            vc, vc2 = vc2, vc
            toks.append(tok)
            parents.append(parent)
        norm = scores / gen_len ** length_penalty
        best = norm.argmax(-1)                                   # [b]
        final_score = scores.gather(1, best[:, None])[:, 0]
        # backtrace: walk the parents from the last step to the prefill
        beam = best
        rev = []
        for t in range(max_new_tokens - 2, -1, -1):
            rev.append(toks[t].gather(1, beam[:, None])[:, 0])
            beam = parents[t].gather(1, beam[:, None])[:, 0]
        first = init_tok.gather(1, beam[:, None])                # [b, 1]
        seq = torch.cat([first, torch.stack(rev[::-1], dim=1)], dim=1)
        return torch.cat([ids, seq], dim=1), final_score


def _gpt_speculative(model, draft_model, input_ids, max_new_tokens, k=4,
                     dtype=None, cache_dtype=None, eos_token_id=None):
    """Speculative greedy decoding: a small draft model proposes k tokens
    a round; the target verifies all k in ONE (k + 1)-token forward and
    accepts the longest matching prefix plus its own fix-up token, so a
    round emits 1..k + 1 tokens and the output is the target's own greedy
    decode (up to argmax flips on near-ties between the multi-token
    verify and single-token steps). Returns (sequences [1, prompt +
    max_new_tokens], n_rounds).

    The reference runs the rounds as one device while_loop. Here the loop
    is on the host and takes ONE host read a round: the accepted count
    (with the eos flag in the same read). Cache invariant: both caches
    hold the accepted prefix [0, pos); `cur`, the last accepted token, is
    not yet fed. A round feeds [cur, p_0..p_{k-1}] to the target, so
    writes may run k columns past the accepted end; those columns are
    causally hidden and overwritten by later rounds.

    Batch 1, greedy only. eos_token_id stops the loop once the accepted
    slice holds eos, filling the tail with eos as generate's done-mask
    does."""
    cfg, ids, b, s0, _, params = _decode_setup(model, input_ids,
                                               max_new_tokens)
    if b != 1:
        raise ValueError(f"speculative decoding is batch-1 (got batch {b}); "
                         "run rows separately, use generate(), or serve "
                         "batches speculatively via inference.serving."
                         "ServingEngine(draft_model=...)")
    if draft_model.cfg.vocab_size != cfg.vocab_size:
        raise ValueError("draft and target must share a vocabulary")
    if not 1 <= k <= 16:
        raise ValueError(f"k must be in [1, 16], got {k}")
    if s0 < 2:
        raise ValueError("speculative decoding needs a prompt of >= 2 tokens")
    d_cfg = draft_model.cfg
    _check_decode_config(d_cfg)
    T = s0 + max_new_tokens + k + 1  # writes can run k past the accepted end
    if T > cfg.max_seq_len or T > d_cfg.max_seq_len:
        raise ValueError(
            f"prompt {s0} + max_new_tokens {max_new_tokens} + draft window "
            f"{k + 1} exceeds a max_seq_len ({cfg.max_seq_len} target, "
            f"{d_cfg.max_seq_len} draft)")
    params_d = _decode_params(draft_model, "the draft model")
    fwd_t, logits_t, cache_init_t = _decode_fns(cfg, cache_dtype)
    fwd_d, logits_d, cache_init_d = _decode_fns(d_cfg, cache_dtype)
    compute_dtype = _decode_compute_dtype(dtype)
    pt, pd = cast_params(params, compute_dtype), \
        cast_params(params_d, compute_dtype)
    dev = ids.device
    ids_d = ids.to(draft_model.device)
    dt = pt["gpt.wte.weight"].dtype
    eos = -1 if eos_token_id is None else int(eos_token_id)
    with torch.no_grad():
        kc_t, vc_t = cache_init_t(1, T, dt, dev)
        kc_d, vc_d = cache_init_d(1, T, dt, ids_d.device)
        # prefill both caches with the prompt minus its last token, which
        # is `cur`, fed at the head of each round
        fwd_t(pt, ids[:, :s0 - 1], 0, kc_t, vc_t)
        fwd_d(pd, ids_d[:, :s0 - 1], 0, kc_d, vc_d)
        cur = ids[:, s0 - 1]                                     # [1]
        out_buf = torch.zeros((1, max_new_tokens + k + 1), dtype=torch.long,
                              device=dev)
        j_idx = torch.arange(k + 1, device=dev)
        pos, emitted, rounds, done = s0 - 1, 0, 0, False
        while emitted < max_new_tokens and not done:
            # the draft proposes k tokens (k single-token forwards)
            props = []
            d_cur = cur.to(ids_d.device)
            for j in range(k):
                xd = fwd_d(pd, d_cur[:, None], pos + j, kc_d, vc_d)
                d_cur = torch.argmax(logits_d(pd, xd[:, -1]).float(), -1)
                props.append(d_cur)
            # write p_{k-1}'s KV too (logits unused): when all k are
            # accepted the next round starts past this column, and an
            # unwritten column inside the accepted prefix would poison
            # every later draft query
            fwd_d(pd, d_cur[:, None], pos + k, kc_d, vc_d)
            props_a = torch.stack(props, dim=1).to(dev)          # [1, k]
            # the target verifies in ONE (k + 1)-token forward
            seq = torch.cat([cur[:, None], props_a], dim=1)
            xt = fwd_t(pt, seq, pos, kc_t, vc_t)
            preds = torch.argmax(logits_t(pt, xt).float(), -1)   # [1, k+1]
            # longest accepted prefix: p_j must equal the target's argmax
            # after the same prefix (preds[:, j])
            m_dev = torch.cumprod((props_a == preds[:, :k]).long(),
                                  dim=1).sum(1)[0]
            fixup = preds[0, m_dev]
            emit = torch.where(j_idx < m_dev, F.pad(props_a[0], (0, 1)),
                               fixup)                            # [k+1]
            if eos >= 0:
                # everything after the first eos of the ACCEPTED slice
                # becomes eos, and the loop stops
                seen = torch.cumsum(((emit == eos) & (j_idx <= m_dev))
                                    .long(), 0) > 0
                emit = torch.where(seen, eos, emit)
                m, stop = torch.stack([m_dev, seen[m_dev].long()]).tolist()
                done = bool(stop)
            else:
                m = int(m_dev)           # the round's one host read
            out_buf[0, emitted:emitted + k + 1] = emit
            pos += m + 1
            emitted += m + 1
            cur = preds[:, m]
            rounds += 1
        out = out_buf[:, :max_new_tokens]
        if eos >= 0:
            # an early stop leaves the tail unwritten: eos, as generate's
            # done-mask would have emitted
            out = torch.where(torch.arange(max_new_tokens, device=dev)[None]
                              >= emitted, eos, out)
        return torch.cat([ids, out], dim=1), rounds


def _not_ported(what):
    raise NotImplementedError(f"{what} is not ported yet")


class GPTDecodeModel(_decode_model.DecodeModel):
    """The gpt family's DecodeModel adapter (serving/decode_model.py): the
    serving engine reaches this module's decode helpers only through it,
    so an engine's outputs equal those of the helpers called directly."""

    name = "gpt"

    def check_config(self, cfg):
        _check_decode_config(cfg)

    def compute_dtype(self, dtype):
        return _decode_compute_dtype(dtype)

    def extract_params(self, model, who):
        """({name: detached param}, aux): the port's head is always tied,
        so aux carries nothing. A model with un-merged LoRA adapters
        raises."""
        return _decode_params(model, who), None

    def decode_fns(self, cfg, aux, cache_dtype=None, tp_axis=None,
                   tp_size=1):
        if tp_axis is not None or tp_size != 1:
            _not_ported("tensor-parallel serving")
        return _decode_fns(cfg, cache_dtype)

    def tp_setup(self, tp_mesh, cfg, params):
        _not_ported("tensor-parallel serving")

    def tp_wrap(self, run, tp_mesh, tp_specs, n_extra_in, out_specs,
                in_specs=None, donate=()):
        _not_ported("tensor-parallel serving")

    def cache_spec(self, cfg):
        return {"kind": "kv_pair",
                "layout": "[L, B, KVh, T, hd]",
                "axes": {"L": cfg.num_layers, "KVh": cfg.num_kv_heads,
                         "T": cfg.max_seq_len,
                         "hd": cfg.hidden_size // cfg.num_heads},
                "quantized": "per-side (values, scales) tuple when the "
                             "engine's cache_dtype is int8/fp8"}

    # multi-LoRA batched decode: the four adapter sites are block()'s four
    # products. Every slot carries all four kinds (absent sites are exact
    # zeros), so loading an adapter into a freed slot is one same-shape
    # write
    _LORA_SITES = {"attn.qkv": "qkv", "attn.proj": "proj",
                   "mlp.fc1": "fc1", "mlp.fc2": "fc2"}

    def _lora_dims(self, cfg):
        Hh, KVh = cfg.num_heads, cfg.num_kv_heads
        hd = cfg.hidden_size // Hh
        h, inner = cfg.hidden_size, cfg.intermediate_size
        return {"qkv": (h, (Hh + 2 * KVh) * hd), "proj": (h, h),
                "fc1": (h, inner), "fc2": (inner, h)}

    def lora_init(self, cfg, n_slots, rank, dtype=None, device="cpu"):
        """The stacked factors of n_slots adapters, all zero: {"scale":
        fp32 [S], kind: {"A": [S, L, din, rank], "B": [S, L, rank,
        dout]}} in `dtype` (None = fp32) on `device`."""
        dt = dtype or torch.float32
        L = cfg.num_layers
        pack = {"scale": torch.zeros((n_slots,), dtype=torch.float32,
                                     device=device)}
        for kind, (din, dout) in self._lora_dims(cfg).items():
            pack[kind] = {
                "A": torch.zeros((n_slots, L, din, rank), dtype=dt,
                                 device=device),
                "B": torch.zeros((n_slots, L, rank, dout), dtype=dt,
                                 device=device)}
        return pack

    def lora_pack(self, cfg, exported, rank):
        """One exported adapter (``incubate.lora.export_lora``) laid out
        as one slot of ``lora_init``: {"scale": float, kind: {"A": fp32
        numpy [L, din, rank], "B": [L, rank, dout]}}, an adapter of lower
        rank zero-padded. Raises ValueError for a rank above `rank`, a
        site outside the four, factors of the wrong shape or a layer out
        of range."""
        L = cfg.num_layers
        r = int(exported["rank"])
        if r > rank:
            raise ValueError(
                f"adapter rank {r} exceeds the engine's lora_rank={rank}; "
                "rebuild the engine with a larger lora_rank")
        dims = self._lora_dims(cfg)
        slot = {"scale": float(exported["scaling"])}
        for kind, (din, dout) in dims.items():
            slot[kind] = {"A": np.zeros((L, din, rank), np.float32),
                          "B": np.zeros((L, rank, dout), np.float32)}
        pat = re.compile(r"(?:^|\.)blocks\.(\d+)\.(attn\.qkv|attn\.proj|"
                         r"mlp\.fc1|mlp\.fc2)$")
        for qual, fac in exported["factors"].items():
            m = pat.search(qual)
            if m is None:
                raise ValueError(
                    f"adapter site {qual!r} has no batched-decode "
                    "injection point (gpt serves LoRA on attn.qkv/"
                    "attn.proj/mlp.fc1/mlp.fc2 only); merge_lora this "
                    "adapter and serve it dense instead")
            i, kind = int(m.group(1)), self._LORA_SITES[m.group(2)]
            A, B = np.asarray(fac["A"]), np.asarray(fac["B"])
            din, dout = dims[kind]
            if A.shape != (din, r) or B.shape != (r, dout):
                raise ValueError(
                    f"adapter site {qual!r}: factors {A.shape}/{B.shape} "
                    f"do not match the config ({(din, r)}/{(r, dout)})")
            if not 0 <= i < L:
                raise ValueError(f"adapter site {qual!r}: layer {i} out of "
                                 f"range for num_layers={L}")
            slot[kind]["A"][i, :, :r] = A
            slot[kind]["B"][i, :r, :] = B
        return slot

    def matches(self, model):
        return isinstance(model, GPTForCausalLM)


_decode_model.register_decode_model(GPTDecodeModel())
