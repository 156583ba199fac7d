"""The port's sharding rules against the reference's, leaf by leaf.

`repro_torch.runtime.sharding.resolve`, and `param_pspecs`,
`zero1_moment_axes` and the ZeRO-1 moment specs of
`repro_torch.runtime.param_sharding`, on the parameter tree of every
architecture's smoke and full config (the reference's from
``jax.eval_shape``, the port's built on the ``meta`` device), under four
bindings: (data 2, model 4), (data 16, model 16) with fsdp off and on,
and (pod 2, data 16, model 16). Only shapes are read: no device, no
process group. Also `launch.mesh.binding_for`'s choice of rules and the
port's `Block` of a ZeRO-1 moment.
"""

import pytest

pytest.importorskip("torch")

import jax  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_config as j_get_config  # noqa: E402
from repro.configs import get_smoke as j_get_smoke  # noqa: E402
from repro.models import get_model as j_get_model  # noqa: E402
from repro.runtime import param_sharding as j_psh  # noqa: E402
from repro.runtime import sharding as j_shlib  # noqa: E402

from repro_torch import tree  # noqa: E402
from repro_torch.configs import _ALIASES, get_config, get_smoke  # noqa: E402
from repro_torch.models.api import family_module  # noqa: E402
from repro_torch.runtime import param_sharding as psh  # noqa: E402
from repro_torch.runtime import sharding as shlib  # noqa: E402

ARCHS = sorted(_ALIASES)
BINDINGS = {
    "data2-model4": ("single", {"data": 2, "model": 4}, False),
    "pod-fsdp-off": ("single", {"data": 16, "model": 16}, False),
    "pod-fsdp-on": ("single", {"data": 16, "model": 16}, True),
    "multi-pod": ("multi", {"pod": 2, "data": 16, "model": 16}, False),
}


def _bindings(name):
    kind, sizes, fsdp = BINDINGS[name]
    j_rules = (j_shlib.SINGLE_POD_RULES if kind == "single"
               else j_shlib.MULTI_POD_RULES)
    rules = (shlib.SINGLE_POD_RULES if kind == "single"
             else shlib.MULTI_POD_RULES)
    return (j_shlib.Binding(j_rules, sizes, fsdp=fsdp),
            shlib.Binding(rules, sizes, fsdp=fsdp))


def _ref_tree(arch, full):
    cfg = (j_get_config if full else j_get_smoke)(arch)
    model = j_get_model(cfg)
    return jax.eval_shape(model.init_params, jax.random.PRNGKey(0))


def _port_tree(arch, full):
    cfg = (get_config if full else get_smoke)(arch)
    return family_module(cfg).init_params(cfg, None, torch.device("meta"))


def _flat_ref(t, is_leaf=None):
    flat, _ = jax.tree_util.tree_flatten_with_path(t, is_leaf=is_leaf)
    return {"/".join(str(getattr(k, "key", k)) for k in path): leaf
            for path, leaf in flat}


def _spec(p):
    return tuple(p)


def _is_axes(x):
    return isinstance(x, tuple) and all(
        a is None or isinstance(a, (str, tuple)) for a in x)


@pytest.fixture(scope="module", params=[(a, full) for a in ARCHS
                                        for full in (False, True)],
                ids=lambda p: f"{p[0]}-{'full' if p[1] else 'smoke'}")
def trees(request):
    arch, full = request.param
    ref, port = _ref_tree(arch, full), _port_tree(arch, full)
    shapes = {k: tuple(v.shape) for k, v in _flat_ref(ref).items()}
    assert shapes == {k: tuple(v.shape) for k, v in tree.items(port)}
    return ref, port


@pytest.mark.parametrize("binding", sorted(BINDINGS))
def test_param_rules_match_reference(trees, binding):
    ref, port = trees
    j_b, b = _bindings(binding)
    with j_shlib.use_binding(j_b):
        j_logical = j_psh.logical_param_axes(ref)
        j_pspecs = j_psh.param_pspecs(ref)
        j_zero1 = j_psh.zero1_moment_axes(j_logical, ref)
        j_moments = j_psh.specs_from_logical(j_zero1, ref, keep_fsdp=True)
    with shlib.use_binding(b):
        logical = psh.logical_param_axes(port)
        pspecs = psh.param_pspecs(port)
        zero1 = psh.zero1_moment_axes(logical, port)
        moments = psh.specs_from_logical(zero1, port, keep_fsdp=True)
    for name, want, got, conv in (
            ("logical", j_logical, logical, None),
            ("param_pspecs", j_pspecs, pspecs, _spec),
            ("zero1_moment_axes", j_zero1, zero1, None),
            ("moment specs", j_moments, moments, _spec)):
        want = _flat_ref(want, is_leaf=_is_axes if conv is None else
                         (lambda x: isinstance(x, jax.sharding.
                                               PartitionSpec)))
        got = dict(tree.items(got))
        assert set(want) == set(got), name
        for path in want:
            w = conv(want[path]) if conv else want[path]
            assert got[path] == w, (name, path, got[path], w)


@pytest.mark.parametrize("binding", sorted(BINDINGS))
def test_resolve_matches_reference(binding):
    j_b, b = _bindings(binding)
    cases = [((), ()), ((8, 16), ("batch", None)),
             ((32, 64, 128), ("batch", None, "model")),
             ((4, 1, 256), ("batch", "kv_heads", None)),
             ((48, 64, 32), ("expert", "fsdp", "model")),
             ((40, 64, 32), ("expert", "fsdp", "model")),
             ((64, 48), (("batch", "model"), None)),
             ((512, 7), ("attn_batch", None)),
             (None, ("vocab", "seq")),
             ((3, 5), ("batch", "model"))]
    for shape, logical in cases:
        with j_shlib.use_binding(j_b):
            want = tuple(j_shlib.resolve(shape, *logical))
        with shlib.use_binding(b):
            got = shlib.resolve(shape, *logical)
        assert got == want, (shape, logical, got, want)
    assert shlib.resolve((8,), "batch") == ()       # no binding


def test_binding_for_picks_the_rules():
    from repro.launch import mesh as j_mesh
    from repro_torch.launch import mesh

    class FakeMesh:          # the two attributes binding_for reads
        def __init__(self, names, shape):
            self.mesh_dim_names = names
            self.mesh = torch.zeros(shape)

    class JFake:
        def __init__(self, names, shape):
            self.axis_names = names
            self.devices = torch.zeros(shape).numpy()

    for names, shape in ((("data", "model"), (4, 1)),
                         (("pod", "data", "model"), (1, 4, 1))):
        got = mesh.binding_for(FakeMesh(names, shape))
        want = j_mesh.binding_for(JFake(names, shape))
        assert got.rules == want.rules
        assert got.axis_sizes == want.axis_sizes
        assert got.fsdp_params == want.fsdp_params


def test_zero1_blocks_follow_the_moment_specs():
    """A ZeRO-1 `Block` on the dim where the moment spec names "data",
    none where no free dim divides (and none without ZeRO-1)."""
    port = _port_tree("qwen3-8b", False)
    b = shlib.Binding(shlib.SINGLE_POD_RULES, {"data": 2, "model": 1})
    b.axis_group = lambda phys: shlib.AxisGroup("g", 2, 1)
    with shlib.use_binding(b):
        moments = psh.specs_from_logical(
            psh.zero1_moment_axes(psh.logical_param_axes(port), port),
            port, keep_fsdp=True)
        blocks = psh.zero1_blocks(port)
        plain = psh.zero1_blocks(port, zero1=False)
    assert all(blk is None for _, blk in tree.items(plain))
    n_split = 0
    for path, spec in tree.items(moments):
        blk = dict(tree.items(blocks))[path]
        dims = [i for i, e in enumerate(spec) if e == "data"]
        if not dims:
            assert blk is None, path
            continue
        n_split += 1
        assert blk.dim == dims[0] and blk.axis.index == 1, path
        leaf = torch.arange(float(
            torch.Size(dict(tree.items(port))[path].shape).numel())
        ).reshape(dict(tree.items(port))[path].shape)
        half = leaf.shape[blk.dim] // 2
        assert torch.equal(blk.take(leaf),
                           leaf.narrow(blk.dim, half, half)), path
        assert blk.full_shape(blk.shape(leaf.shape)) == tuple(leaf.shape)
    assert n_split > 10


def test_binding_reaches_a_remat_recompute_on_another_thread():
    """A layer body under `models.common.remat` is recomputed in the
    backward; on the card autograd runs the backward on a thread of its
    own. Run here on another thread, the recompute sees the binding its
    forward saw (MoE's capacity and the loss's token count read it)."""
    import threading

    from repro_torch.models import common

    cfg = get_smoke("granite-moe-3b-a800m", remat=True)
    seen, errors = [], []

    def body(x):
        seen.append(shlib.current_binding())
        return (x * x).sum()

    b = shlib.Binding(shlib.SINGLE_POD_RULES, {"data": 2, "model": 1})
    x = torch.ones(3, requires_grad=True)

    def backward(y):
        try:
            y.backward()
        except BaseException as exc:
            errors.append(exc)

    with shlib.use_binding(b):
        y = common.remat(cfg, body)(x)
        t = threading.Thread(target=backward, args=(y,))
        t.start()
        t.join()
    assert not errors, errors
    assert len(seen) == 2 and all(s is b for s in seen), seen
    assert torch.equal(x.grad, 2 * torch.ones(3))
    assert shlib.current_binding() is None
