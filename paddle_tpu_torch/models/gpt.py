"""GPT-2 style causal LM: the forward, the pretraining loss and KV-cache
``generate``.

Ports paddle_tpu/models/gpt.py: ``GPTConfig``, ``GPTAttention`` (GQA and
sliding window), ``GPTMLP``, ``GPTBlock`` with its ``_tpp_mlp`` hook,
``GPTModel``, ``GPTForCausalLM`` with the tied head ``h @ wte^T`` and its
``loss``, ``GPTPretrainLoss``, the decode path (``_decode_fns``,
``_check_decode_config``, ``_decode_compute_dtype``, ``_decode_setup``,
``_gpt_generate``), and ``GPTDecodeModel``, the family's adapter for the
serving engine, registered at import.

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

Linear layers are ``torch.nn.Linear`` (weight [out, in]); the reference's
``nn.Linear`` stores [in, out], which ``models/convert.py`` transposes.
Parameter names are the reference's (``gpt.blocks.{i}.attn.qkv.weight``,
...). Tensor-parallel, MoE and sequence-parallel configurations are not
ported yet and are refused by ``GPTConfig``.
"""
import math
import operator

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
from ..ops import tpp
from ..serving import decode_model as _decode_model


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
        self.qkv = nn.Linear(h, qkv_out)
        self.proj = nn.Linear(h, h)
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
        self.fc1 = nn.Linear(h, i)
        self.fc2 = nn.Linear(i, h)
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
        return F.linear(h, self.gpt.wte.weight)   # tied head: h @ wte^T

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
        fp32). Returns [b, prompt + max_new_tokens] int64 ids, prompt
        included. Beam search, quantized caches, ragged prompts and
        tensor-parallel serving are not ported yet."""
        if num_beams > 1:
            raise NotImplementedError("beam search is not ported yet")
        if cache_dtype is not None:
            raise NotImplementedError(
                f"cache_dtype={cache_dtype!r}: quantized KV caches are not "
                "ported yet")
        if attention_mask is not None:
            raise NotImplementedError(
                "attention_mask (ragged prompts) is not ported yet")
        if tp_mesh is not None:
            raise NotImplementedError(
                "tensor-parallel serving is not ported yet")
        return _gpt_generate(self, input_ids, max_new_tokens, temperature,
                             top_k, seed, eos_token_id, dtype=dtype,
                             top_p=top_p)

    def generate_speculative(self, draft_model, input_ids,
                             max_new_tokens=32, k=4, dtype=None,
                             cache_dtype=None, tp_mesh=None,
                             eos_token_id=None):
        raise NotImplementedError("speculative decoding is not ported yet")


class GPTPretrainLoss(nn.Module):
    """loss_fn for SpmdTrainer: logits [b, s, v] and labels [b, s] -> the
    mean cross-entropy over the b * s rows."""

    def forward(self, logits, labels):
        b, s, v = logits.shape
        return cross_entropy(logits.reshape(b * s, v), labels.reshape(b * s))


# ---------------------------------------------------------------------------
# Autoregressive decoding with a KV cache (the serving path).
# ---------------------------------------------------------------------------

def _decode_fns(cfg):
    """Plain-PyTorch decode math over name-addressed params (port layout:
    Linear weights [out, in]). Returns (fwd, logits_of, cache_init).
    fwd(p, tok_ids [B, t], pos, kc, vc) runs the block stack with its first
    column at cache column `pos` and writes K/V into the cache
    [L, B, KVh, T, hd] IN PLACE (the reference's dynamic_update_slice
    returns a new array; here the pre-allocated cache is mutated). `pos` is
    an int (the whole batch at one frontier) or a [B] tensor (each row at
    its own frontier: continuous batching). fwd and logits_of run with
    autocast off: they compute in the dtype of their params and cache.
    The reference's quantized caches (cache_dtype), tensor-parallel heads
    (tp_axis), left-padded rows (key_valid, pos_ids) and per-row LoRA
    deltas (lora) are not ported."""
    L, Hh = cfg.num_layers, cfg.num_heads
    hd = cfg.hidden_size // Hh
    scale = 1.0 / math.sqrt(hd)
    win = cfg.attention_window
    KVh = cfg.num_kv_heads   # GQA: compact K/V heads
    g = Hh // KVh            # query heads per kv head
    gelu = "tanh" if cfg.gelu_approx else "none"

    def cache_init(b_, T_, dtype, device):
        z = torch.zeros((L, b_, KVh, T_, hd), dtype=dtype, device=device)
        return z, torch.zeros_like(z)

    def ln(x, w, bb):
        mu = x.mean(-1, keepdim=True)
        var = ((x - mu) ** 2).mean(-1, keepdim=True)
        return (x - mu) / torch.sqrt(var + 1e-5) * w + bb

    def store(c, i, val, pos, per_row):
        """val [B, KVh, t, hd] into layer i at column pos (per row: row b
        at its own pos[b])."""
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

    def block(p, i, x, kc, vc, pos, per_row):
        pre = f"gpt.blocks.{i}."
        bb, t = x.shape[0], x.shape[1]
        T = kc.shape[3]
        h_in = ln(x, p[pre + "ln1.weight"], p[pre + "ln1.bias"])
        flat = F.linear(h_in, p[pre + "attn.qkv.weight"],
                        p[pre + "attn.qkv.bias"])
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
        if g == 1:
            att = torch.einsum("bhtd,bhTd->bhtT", q, kc[i]) * scale
            att = torch.softmax(att.masked_fill(~mask[:, None], -math.inf),
                                dim=-1)
            out = torch.einsum("bhtT,bhTd->bhtd", att, vc[i])
        else:
            # grouped queries share their kv head: [B, KVh, g, t, *]
            qg = q.reshape(bb, KVh, g, t, hd)
            att = torch.einsum("bkgtd,bkTd->bkgtT", qg, kc[i]) * scale
            att = torch.softmax(
                att.masked_fill(~mask[:, None, None], -math.inf), dim=-1)
            out = torch.einsum("bkgtT,bkTd->bkgtd", att, vc[i]).reshape(
                bb, Hh, t, hd)
        out = out.transpose(1, 2).reshape(bb, t, Hh * hd)
        x = x + F.linear(out, p[pre + "attn.proj.weight"]) \
            + p[pre + "attn.proj.bias"]
        h2 = ln(x, p[pre + "ln2.weight"], p[pre + "ln2.bias"])
        a1 = F.linear(h2, p[pre + "mlp.fc1.weight"], p[pre + "mlp.fc1.bias"])
        mlp = F.linear(F.gelu(a1, approximate=gelu), p[pre + "mlp.fc2.weight"])
        return x + mlp + p[pre + "mlp.fc2.bias"]

    def logits_of(p, x_last):
        with _autocast_off():
            h = ln(x_last, p["gpt.ln_f.weight"], p["gpt.ln_f.bias"])
            return F.linear(h, p["gpt.wte.weight"])

    def fwd(p, tok_ids, pos, kc, vc):
        t = tok_ids.shape[1]
        wpe = p["gpt.wpe.weight"]
        per_row = torch.is_tensor(pos) and pos.ndim == 1
        with _autocast_off():
            if per_row:
                # per-row positions need per-row pe; an inactive row past
                # the table (pos == T after a capacity finish) reads the
                # last row instead of the reference's NaN fill
                ids = (pos[:, None] + torch.arange(t, device=pos.device)) \
                    .clamp(max=wpe.shape[0] - 1)
                x = p["gpt.wte.weight"][tok_ids] + wpe[ids]
            else:
                x = p["gpt.wte.weight"][tok_ids] + wpe[pos:pos + t]
            for i in range(L):
                x = block(p, i, x, kc, vc, pos, per_row)
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
    params = {n: p.detach() for n, p in model.named_parameters()}
    return cfg, ids, b, s0, T, params


def _gpt_generate(model, input_ids, max_new_tokens, temperature, top_k,
                  seed, eos_token_id, dtype=None, top_p=None):
    """Prefill, then one step per new token against a cache of static
    shape [L, b, KVh, prompt + max_new_tokens, hd] (parity against the
    cache-free forward is what tests/test_torch_gpt.py pins)."""
    cfg, ids, b, s0, T, p = _decode_setup(model, input_ids, max_new_tokens)
    fwd, logits_of, cache_init = _decode_fns(cfg)
    compute_dtype = _decode_compute_dtype(dtype)
    if compute_dtype is not None:
        # serving precision: bf16 params + bf16 KV cache; logits in fp32
        p = {k: v.to(compute_dtype) if v.is_floating_point() else v
             for k, v in p.items()}
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
        x = fwd(p, ids, 0, kc, vc)
        tok = pick(logits_of(p, x[:, -1]).float())
        done = None if eos_token_id is None else tok == eos_token_id
        toks = [tok]
        for i in range(1, max_new_tokens):
            # the fed token is the (i-1)-th generated one: cache column
            # s0 + i - 1
            x = fwd(p, tok[:, None], s0 + i - 1, kc, vc)
            tok = pick(logits_of(p, x[:, 0]).float())
            if done is not None:
                tok = torch.where(done, torch.full_like(tok, eos_token_id),
                                  tok)
                done = done | (tok == eos_token_id)
            toks.append(tok)
        return torch.cat([ids, torch.stack(toks, dim=1)], dim=1)


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
        so aux carries nothing."""
        return {n: p.detach() for n, p in model.named_parameters()}, None

    def decode_fns(self, cfg, aux, cache_dtype=None, tp_axis=None,
                   tp_size=1):
        if cache_dtype is not None:
            _not_ported(f"cache_dtype={cache_dtype!r} (quantized KV caches)")
        if tp_axis is not None or tp_size != 1:
            _not_ported("tensor-parallel serving")
        return _decode_fns(cfg)

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
                "quantized": None}

    def lora_init(self, cfg, n_slots, rank, dtype=None):
        _not_ported("multi-LoRA serving")

    def lora_pack(self, cfg, exported, rank):
        _not_ported("multi-LoRA serving")

    def matches(self, model):
        return isinstance(model, GPTForCausalLM)


_decode_model.register_decode_model(GPTDecodeModel())
