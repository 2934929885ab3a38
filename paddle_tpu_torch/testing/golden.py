"""The narrow GPT whose JAX-package outputs are committed as fixtures.

``chip_smoke.py`` runs the port's eval forward and greedy ``generate`` of
this model on the card and holds them against
``fixtures/gpt_narrow_seq1024.npz``, which holds the JAX package's outputs
for the same weights and ids (tests/test_torch_gpt.py regenerates them
from the JAX package and checks the committed file still matches; run
``python tests/test_torch_gpt.py --write-fixture`` to rewrite it). It also
trains the model for TRAIN_STEPS AdamW steps (lr TRAIN_LR, fresh state,
the next-token labels of ``train_labels``) in fp32 and under bf16
``auto_cast`` and holds the losses and the parameter slices of
``kept_rows`` against ``fixtures/gpt_narrow_train_seq1024.npz``, the JAX
package's SpmdTrainer run of the same steps (``python
tests/test_torch_trainer.py --write-train-fixture`` rewrites it;
tests/test_torch_trainer.py checks it still matches).

Weights and ids come from a numpy seed, in the JAX package's layout
(Linear weights [in, out]) and under its parameter names, so both
packages load the same numbers: the JAX model through ``set_value``, the
port through ``models.convert.params_from_jax``.
"""
from pathlib import Path

import numpy as np

#: vocab 512, hidden 128, 2 layers, 2 heads (head_dim 64), seq 1024: the
#: smallest model whose eval forward at 1 x 1024 reaches the flash kernel
NARROW = dict(vocab_size=512, hidden_size=128, num_layers=2, num_heads=2,
              max_seq_len=1024, dropout=0.0)
SEED = 0
SEQ = 1024
LOGIT_ROWS = 8       # the last rows of the 1 x 1024 logits kept
PROMPT = 64          # greedy generate: the first 64 ids as the prompt
NEW_TOKENS = 32
FIXTURE = Path(__file__).resolve().parent / "fixtures" / \
    "gpt_narrow_seq1024.npz"
TRAIN_FIXTURE = FIXTURE.with_name("gpt_narrow_train_seq1024.npz")
TRAIN_STEPS = 3
TRAIN_LR = 1e-4
#: parameters whose first KEPT_ROWS rows (JAX layout) the train fixture keeps
KEPT_PARAMS = ("gpt.wte.weight", "gpt.blocks.0.attn.qkv.weight",
               "gpt.blocks.0.attn.qkv.bias", "gpt.blocks.0.ln1.weight",
               "gpt.blocks.1.mlp.fc1.weight", "gpt.blocks.1.mlp.fc2.bias",
               "gpt.ln_f.bias")
KEPT_ROWS = 4
#: limit of update_rel_err for a bf16 auto_cast run against the JAX
#: package's. bf16 rounds at different places in the two packages, and
#: Adam's normalised step turns a rounding-sized grad difference into an
#: lr-sized step wherever a grad is near zero: the port's plain versions
#: read 0.032 on the CPU, as far as the JAX package's own bf16 run lies
#: from its fp32 run (0.030). A backward whose dQ is zero reads 0.36, one
#: whose dK and dV are zero 0.52 (tests/test_torch_trainer.py holds both).
TRAIN_BF16_UPDATE_RTOL = 0.1


def param_shapes(cfg=NARROW):
    """{name: shape} of GPTForCausalLM's parameters in the JAX layout."""
    h, v, t = cfg["hidden_size"], cfg["vocab_size"], cfg["max_seq_len"]
    shapes = {"gpt.wte.weight": (v, h), "gpt.wpe.weight": (t, h)}
    for i in range(cfg["num_layers"]):
        pre = f"gpt.blocks.{i}."
        shapes.update({
            pre + "ln1.weight": (h,), pre + "ln1.bias": (h,),
            pre + "attn.qkv.weight": (h, 3 * h), pre + "attn.qkv.bias": (3 * h,),
            pre + "attn.proj.weight": (h, h), pre + "attn.proj.bias": (h,),
            pre + "ln2.weight": (h,), pre + "ln2.bias": (h,),
            pre + "mlp.fc1.weight": (h, 4 * h), pre + "mlp.fc1.bias": (4 * h,),
            pre + "mlp.fc2.weight": (4 * h, h), pre + "mlp.fc2.bias": (h,),
        })
    shapes.update({"gpt.ln_f.weight": (h,), "gpt.ln_f.bias": (h,)})
    return shapes


def jax_layout_params(seed=SEED, cfg=NARROW):
    """{name: float32 array}: normal weights (std 0.02), LayerNorm weights
    near 1, small biases, drawn in param_shapes() order."""
    rng = np.random.RandomState(seed)
    out = {}
    for name, shape in param_shapes(cfg).items():
        if name.endswith("ln1.weight") or name.endswith("ln2.weight") \
                or name.endswith("ln_f.weight"):
            a = 1.0 + 0.1 * rng.standard_normal(shape)
        else:
            a = 0.02 * rng.standard_normal(shape)
        out[name] = a.astype(np.float32)
    return out


def input_ids(seed=SEED, cfg=NARROW):
    """[1, SEQ] int32 ids."""
    rng = np.random.RandomState(seed + 1)
    return rng.randint(0, cfg["vocab_size"], (1, SEQ)).astype(np.int32)


def train_labels(seed=SEED, cfg=NARROW):
    """[1, SEQ] int32 next-token labels of ``input_ids``: the ids shifted
    left by one, the last label wrapping to the first id."""
    return np.roll(input_ids(seed, cfg), -1, axis=1)


def kept_rows(named):
    """{name: the first KEPT_ROWS rows of each KEPT_PARAMS parameter} from
    {name: array in the JAX layout (Linear weights [in, out])}."""
    return {n: np.asarray(named[n])[:KEPT_ROWS] for n in KEPT_PARAMS}


def update_rel_err(rows, want_rows):
    """||Δrows - Δwant|| / ||Δwant|| over the kept rows: Δ is a run's
    kept_rows minus those of the initial weights (jax_layout_params()),
    the L2 norms taken over every kept value together. `rows` is
    {name: array}; `want_rows` is {name: array} under the same names."""
    init = kept_rows(jax_layout_params())
    num = sum(float(np.square(np.asarray(rows[n], np.float64)
                              - np.asarray(want_rows[n], np.float64)).sum())
              for n in KEPT_PARAMS)
    den = sum(float(np.square(np.asarray(want_rows[n], np.float64)
                              - init[n].astype(np.float64)).sum())
              for n in KEPT_PARAMS)
    return (num / den) ** 0.5


def port_kept_rows(params):
    """kept_rows of the port's parameters {name: tensor}, in the JAX
    layout (a Linear weight [out, in] is read through its transpose)."""
    from ..models.convert import _LINEAR_WEIGHT

    out = {}
    for n in KEPT_PARAMS:
        t = params[n].detach().float().cpu()
        if _LINEAR_WEIGHT.search(n):
            t = t.t()
        out[n] = t[:KEPT_ROWS].numpy()
    return out
