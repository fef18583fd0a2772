"""Where the port's int8 towers part from tpualign's, on the CPU (ROADMAP
settled difference 26).

The int8 towers quantize each of a block's four product inputs per row
(``round(t / scale)``, the scale from the row's absmax): ``in_proj`` reads
``ln_1``'s output, ``out_proj`` the attention context, ``c_fc`` ``ln_2``'s
output and ``c_proj`` the activation. Two fp32 values an ulp apart can
round to different codes, and one code moves an embedding by up to about
1e-3. These tests find which of those inputs rounds otherwise:

- the two LayerNorms (tpualign's flax module applied on its own, jitted
  and eager, against the port's) agree within 8 fp32 ulps of each row's
  largest output at the towers' widths (4 on these rows), and differ on most
  rows;
- tpualign's jitted tower runs with its LayerNorm outputs captured (flax
  ``capture_intermediates``) and the input and output of every int8 product
  recorded (``tpualign.ops.quant.int8_dot`` wrapped for the trace; the
  embedding stays bit-equal to the plain jitted tower's), and the port's
  tower runs with some of them swapped in. On the input where the int8
  embed engines are 1.3e-3 apart (``tests/test_torch_sharding.py``: TINY77,
  params seed 1, the 13 images of ``default_rng(5)``), the first code that
  differs is one code of block 0's attention context in front of
  ``out_proj`` (image row 4). Given tpualign's ``ln_1`` output, the port's
  qkv equals tpualign's bit for bit and its context differs by a few ulps:
  the port's attention sums in another order than XLA's einsum and
  softmax. With only the attention contexts swapped in, every other code
  equals tpualign's, the port's own LayerNorms included, and every row is
  within 1e-6. With only the LayerNorm outputs swapped in, the rows are
  within 1e-6 too, but the context's code still differs: the swapped
  ``ln_2`` reads tpualign's stream and hides it. So on this input the
  attention context makes the gap, and the LayerNorm's ulps flip no code.
- the text tower, on ``tests/test_torch_int8.py``'s tokens (no code
  differs) and on the chunk texts of the sharding test: there one context
  code differs after its row's EOT token, and ``ln_2``'s ulps move one row
  scale of ``c_fc`` and so one code of the activation in front of
  ``c_proj``; with both swapped in, no other code differs. Within 1e-6 of
  tpualign's under every swap.

``ln_post`` and ``ln_final`` are never swapped: they feed the fp32
projection, not an int8 product, and swapping them would make the
embedding tpualign's by construction.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from tests.test_models import TINY
from tests.test_torch_embed import TINY77, _chunk_records
from tests.test_torch_int8 import _jax_codes, _tokens
from tpualign.models.clip import CLIP as JaxCLIP
from tpualign.models.clip import init_clip_params as jax_init
from tpualign.models.layers import LayerNorm as JaxLayerNorm
from tpualign.ops import quant as jax_quant
from tpualign_torch import config as torch_config
from tpualign_torch.models import CLIP, from_jax_params
from tpualign_torch.models import layers
from tpualign_torch.models.layers import LayerNorm
from tpualign_torch.ops import quant
from tpualign_torch.tokenizer import ClipTokenizer

pytestmark = pytest.mark.fast

SITES = ("in_proj", "out_proj", "c_fc", "c_proj")  # a block's products, in call order
LN_ULPS = 8


@pytest.mark.parametrize("jit", [True, False], ids=["jit", "eager"])
@pytest.mark.parametrize("width", [32, 64, 512, 768, 1024, 1280])
def test_layernorms_agree_within_a_few_ulps(width, jit):
    """The same fp32 rows (each row's mean within one standard deviation
    of 0, scales from 0.1 to 10) through both LayerNorms: within
    ``LN_ULPS`` ulps of each row's largest output, and not bit-equal on
    every row. The two reduce the mean and the variance in other orders."""
    rng = np.random.default_rng(width)
    spread = rng.uniform(0.1, 10.0, size=(256, 1))
    x = ((rng.normal(size=(256, width)) + rng.uniform(-1, 1, size=(256, 1))) * spread)
    x = x.astype(np.float32)
    scale = rng.normal(1.0, 0.2, size=width).astype(np.float32)
    bias = (rng.normal(size=width) * 0.1).astype(np.float32)
    variables = {"params": {"scale": jnp.asarray(scale), "bias": jnp.asarray(bias)}}
    apply = lambda v, a: JaxLayerNorm().apply(v, a)  # noqa: E731
    want = np.asarray((jax.jit(apply) if jit else apply)(variables, jnp.asarray(x)))
    ln = LayerNorm(width)
    with torch.no_grad():
        ln.scale.copy_(torch.from_numpy(scale))
        ln.bias.copy_(torch.from_numpy(bias))
        got = ln(torch.from_numpy(x)).numpy()
    ulp = np.spacing(np.abs(want).max(axis=1, keepdims=True))
    assert (np.abs(got - want) <= LN_ULPS * ulp).all()
    assert (got != want).any(axis=1).any()


@dataclasses.dataclass
class Case:
    """One tower on one input, as tpualign's jitted tower computes it."""
    port: CLIP
    tower: str
    x: np.ndarray
    want: np.ndarray   # tpualign's embeddings
    lns: dict          # the port's LayerNorm name -> tpualign's output
    dots: list         # [((block, site), tpualign's input)] in call order
    qkv: list          # tpualign's in_proj outputs, a block each


def _case(variant, seed, tower, x) -> Case:
    jmodel = JaxCLIP(variant=variant, use_quick_gelu=True, compute_dtype=jnp.float32,
                     quant="int8")
    params = jax_init(JaxCLIP(variant=variant, use_quick_gelu=True,
                              compute_dtype=jnp.float32), seed=seed)
    method = jmodel.encode_image if tower == "image" else jmodel.encode_text
    plain = jax.jit(lambda p, a: jmodel.apply({"params": p}, a, normalize=True,
                                              method=method))(params, x)
    int8_dot = jax_quant.int8_dot

    def traced(p, a):
        seen = []

        def recording(t, kernel, bias=None):
            out = int8_dot(t, kernel, bias)
            seen.append((t, out))
            return out

        with pytest.MonkeyPatch.context() as mp:
            mp.setattr(jax_quant, "int8_dot", recording)
            out, state = jmodel.apply(
                {"params": p}, a, normalize=True, method=method,
                capture_intermediates=lambda m, name: isinstance(m, JaxLayerNorm),
                mutable=["intermediates"])
        return out, state["intermediates"], seen

    out, inter, seen = jax.jit(traced)(params, x)
    np.testing.assert_array_equal(np.asarray(out), np.asarray(plain))
    tree = inter["visual" if tower == "image" else "text"]
    lns = {}
    for name, value in tree.items():
        if name.startswith("ln_"):
            lns[name] = value["__call__"][0]
    for block, value in tree["transformer"].items():
        i = int(block.removeprefix("resblock_"))
        for ln in ("ln_1", "ln_2"):
            lns[f"transformer.resblocks.{i}.{ln}"] = value[ln]["__call__"][0]
    dots = [((n // 4, SITES[n % 4]), torch.from_numpy(np.array(t)))
            for n, (t, _) in enumerate(seen)]
    qkv = [torch.from_numpy(np.array(o)) for n, (_, o) in enumerate(seen) if n % 4 == 0]
    port = from_jax_params(
        CLIP(torch_config.ClipVariant(**dataclasses.asdict(variant)), True, torch.float32,
             False, "int8"),
        jax.tree.map(np.asarray, params)).requires_grad_(False)
    return Case(port, tower, x, np.asarray(out),
                {k: torch.from_numpy(np.array(v)) for k, v in lns.items()}, dots, qkv)


def _port_run(case: Case, swap_lns=False, swap_sites=()):
    """Run the port's tower once, patched. ``swap_lns``: every LayerNorm
    that feeds an int8 product or the stream (all but ``ln_post`` and
    ``ln_final``) returns tpualign's output; ``swap_sites``: those product
    inputs are tpualign's. Returns a record: ``own`` (the port's own input
    at each product, in call order), ``qkv`` (its ``in_proj`` outputs),
    ``swapped_lns``."""
    tower = case.port.visual if case.tower == "image" else case.port.text
    ln_names = {m: n for n, m in tower.named_modules() if isinstance(m, LayerNorm)}
    sites = {}
    for i, block in enumerate(tower.transformer.resblocks):
        for site, kernel in zip(SITES, (block.attn.in_proj_kernel, block.attn.out_proj_kernel,
                                        block.mlp.c_fc_kernel, block.mlp.c_proj_kernel)):
            sites[id(kernel)] = (i, site)
    record = {"own": [], "qkv": [], "swapped_lns": []}
    forward, dot = LayerNorm.forward, layers._QUANT_DOTS["int8"]
    want = dict(case.dots)

    def layer_norm(self, x):
        name = ln_names[self]
        if not swap_lns or name in ("ln_post", "ln_final"):
            return forward(self, x)
        record["swapped_lns"].append(name)
        return case.lns[name].to(x.dtype)

    def int8_dot(x, kernel, bias=None):
        where = sites[id(kernel)]
        record["own"].append((where, x))
        out = dot(want[where] if where[1] in swap_sites else x, kernel, bias)
        if where[1] == "in_proj":
            record["qkv"].append(out)
        return out

    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(LayerNorm, "forward", layer_norm)
        mp.setitem(layers._QUANT_DOTS, "int8", int8_dot)
        with torch.no_grad():
            x = torch.from_numpy(case.x)
            record["got"] = (case.port.encode_image(x, normalize=True) if case.tower == "image"
                             else case.port.encode_text(x, normalize=True)).numpy()
    return record


def _code_flips(case: Case, own) -> dict:
    """``(block, site) -> [(row, position, channel)]`` where the port's own
    product input quantizes to another int8 code than tpualign's input
    does with tpualign's jitted quantizer."""
    assert [w for w, _ in own] == [w for w, _ in case.dots]
    flips = {}
    for (where, mine), (_, theirs) in zip(own, case.dots):
        codes, _ = quant._quantize_rows(mine)
        want, _ = _jax_codes(theirs.numpy())
        diff = np.argwhere(codes.numpy() != want)
        if len(diff):
            flips[where] = [tuple(int(v) for v in d) for d in diff]
    return flips


def _gap(case: Case, got: np.ndarray) -> np.ndarray:
    return np.abs(got - case.want).max(axis=1)


@pytest.fixture(scope="module")
def image_case():
    images = np.random.default_rng(5).normal(size=(13, 32, 32, 3)).astype(np.float32)
    return _case(TINY77, 1, "image", images)


def test_int8_image_gap_starts_at_one_attention_context_code(image_case):
    """As the towers run: image row 4 is 1.3e-3 from tpualign's, the other
    rows within 1e-6; the first code that differs, in call order, is one
    code of block 0's attention context in front of ``out_proj``, in row
    4; the later codes that differ are all in row 4."""
    run = _port_run(image_case)
    gap, flips = _gap(image_case, run["got"]), _code_flips(image_case, run["own"])
    assert int(gap.argmax()) == 4 and 1e-3 < float(gap[4]) < 2e-3
    assert float(np.delete(gap, 4).max()) < 1e-6
    first = next(iter(flips))
    assert first == (0, "out_proj") and len(flips[first]) == 1
    assert {row for codes in flips.values() for row, *_ in codes} == {4}


def test_int8_image_tower_with_tpualigns_attention_contexts(image_case):
    """Only ``out_proj``'s inputs (the attention contexts) swapped in, the
    port's own LayerNorms everywhere: every other code of every block
    equals tpualign's, so the LayerNorm's ulps flip none here; every row
    within 1e-6 of tpualign's, row 4 included."""
    run = _port_run(image_case, swap_sites=("out_proj",))
    gap, flips = _gap(image_case, run["got"]), _code_flips(image_case, run["own"])
    assert list(flips) == [(0, "out_proj")] and flips[(0, "out_proj")][0][0] == 4
    assert float(gap.max()) <= 1e-6


def test_int8_image_tower_with_tpualigns_layernorms(image_case):
    """tpualign's ``ln_pre``, ``ln_1`` and ``ln_2`` outputs swapped in:
    the port's qkv equals tpualign's bit for bit, every row within 1e-6,
    row 4 included. The attention context of block 0 still rounds one code
    the other way, so the LayerNorm is not the cause: the swapped ``ln_2``
    reads tpualign's stream and hides the flipped code."""
    run = _port_run(image_case, swap_lns=True)
    gap, flips = _gap(image_case, run["got"]), _code_flips(image_case, run["own"])
    assert len(run["swapped_lns"]) == 1 + 2 * len(image_case.qkv)
    for mine, theirs in zip(run["qkv"], image_case.qkv):
        torch.testing.assert_close(mine, theirs, rtol=0, atol=0)
    assert float(gap.max()) <= 1e-6
    assert list(flips) == [(0, "out_proj")] and flips[(0, "out_proj")][0][0] == 4


def _text_case(which):
    if which == "int8_tokens":
        return _case(TINY, 0, "text", _tokens())
    texts = [c["text"] or "" for c in _chunk_records()]
    return _case(TINY77, 1, "text", np.asarray(ClipTokenizer()(texts), np.int32))


SWAPS = {"layernorms": {"swap_lns": True},
         "attention_contexts": {"swap_sites": ("out_proj",)},
         "both": {"swap_lns": True, "swap_sites": ("out_proj",)}}


@pytest.mark.parametrize("swap", list(SWAPS))
@pytest.mark.parametrize("which", ["int8_tokens", "chunk_texts"])
def test_int8_text_tower_with_tpualigns_inputs(which, swap):
    """The text tower with tpualign's ``ln_1``/``ln_2`` outputs, its
    attention contexts, or both swapped in (``ln_final`` the port's own):
    within 1e-6 of tpualign's. On ``tests/test_torch_int8.py``'s tokens no
    code differs. On the chunk texts one context code of block 0 differs,
    on a position after its row's EOT token, which no earlier position
    attends to; and with the port's own LayerNorms, ``ln_2``'s ulps move
    one row scale of block 0's ``c_fc`` (its codes all equal) and so one
    code of the activation in front of ``c_proj`` (row 5, before its EOT
    token), which later codes of that row follow. With both swapped in, no
    code but the swapped context differs: the activation rounds none."""
    case = _text_case(which)
    run = _port_run(case, **SWAPS[swap])
    gap, flips = _gap(case, run["got"]), _code_flips(case, run["own"])
    assert float(gap.max()) <= 1e-6
    if which == "int8_tokens":
        assert flips == {}
        return
    eot = np.argmax(case.x, axis=1)
    assert all(pos > eot[row] for row, pos, _ in flips[(0, "out_proj")])
    if swap == "attention_contexts":
        assert (0, "c_fc") not in flips
        assert [(row, pos) for row, pos, _ in flips[(0, "c_proj")]] == [(5, 11)] and eot[5] > 11
        mine = dict(run["own"])[(0, "c_fc")]
        _, theirs = _jax_codes(dict(case.dots)[(0, "c_fc")].numpy())
        assert quant._absmax_scale(mine, -1)[5, 11].item() != theirs[5, 11].item()
    else:
        assert list(flips) == [(0, "out_proj")]
