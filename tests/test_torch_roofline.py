"""Port vs reference: the roofline (``launch/roofline.py``).

The reference runs in subprocesses, its ``launch/roofline.py`` imported
only there (it sets ``XLA_FLAGS`` to 512 host devices when imported), on
8 host devices and a (pod 2, data 2, model 2) ``AxisType.Auto`` mesh
(ROADMAP R2). Each tiny arch (``tiny_of``, sequence 32, batch 8) is
lowered per class, at train, prefill and decode, as the reference's
analysis lowerings are (``q_chunk=0``, ``loss_chunk=10**9``,
``microbatch=0``): the depth-0 model and a one-layer model of each
(kind, window) class (whisper: one encoder and one decoder layer, and
one more of each). Its dot and convolution flops are parsed from
``lowered.compile().as_text()``: 2 x result elements x contracting size,
each computation weighted by the trips of the loops that call it (XLA's
``known_trip_count``: the sLSTM's time loop and the layer scans), per
device x 8 devices. The port counts the same configs on a (2, 2, 1) mesh
of ``meta`` entries, one rank's body x its 4 data-parallel ranks: no
product splits over 'model' there, and a rank's body is its share of
the whole model's products (on (2, 2, 2) the port's train step and its
mesh prefill and decode split them over 'model' as XLA does, and the
count is one coordinate's: ``tests/test_torch_tp.py`` and
``tests/test_torch_serve_mesh.py`` hold that against XLA's per-device
count).

Each lowering is also compiled on a one-device mesh, whose count is the
whole model's products once: on the (2, 2, 2) mesh XLA repeats on both
'model' devices every product whose dims do not split over 'model' (the
K/V projections of tiny h2o-danube's, yi's and qwen2-vl's single KV
head, the whisper decoder's projections, a moe decode step's experts),
so per device x 8 counts them twice and exceeds the whole model's by up
to 76% (tiny qwen3-moe's decode class); the port computes a rank's rows
once. The port is held to the one-device
count; the (2, 2, 2) count is held to be no smaller.

Tolerances: ``model_flops`` exact; the matmul flops within 1% of the
reference's one-device count, every class, after two differences by
design that are added exactly (``_by_design``):
- to train (every LM; not whisper, whose loss is one ``ce_loss``), the
  port recomputes each loss chunk's head projection in backward
  (``chunked_ce_from_hidden`` checkpoints each chunk; the reference's scan
  saves it): one more head forward, 2 x B x S x D x V;
- a moe decode step routes its rows as one group (both packages), and in
  the port each data-parallel rank routes its own rows: every rank's
  experts run at ``capacity(rows)`` slots, padded to 8, where the
  reference runs ``capacity(B)`` once: (RANKS x capacity(B / RANKS) -
  capacity(B)) x E slots more, 3 x 2 x D x d_ff flops each. The MoE
  products run over the gathered [B, E, C, D] layout in both packages, so
  both count capacity, not the active experts.
Then the per-class combination equal to a direct count of the whole
model, exactly (flops, eager bytes, unique bytes); the collective bytes
equal to the mesh step's ``Traffic``; the kernel gate's attention flops
equal to the kernel's band (``chip_smoke.py``'s pair count).
"""
import dataclasses
import json
import os
import subprocess
import sys
import textwrap

import pytest
import torch

from repro_torch.configs.base import (ARCH_IDS, SHAPES, RunConfig,
                                      TrainConfig, get_model_config, resolve,
                                      supported_shapes)
from repro_torch.configs.tiny import tiny_of
from repro_torch.launch import dryrun
from repro_torch.launch import roofline as R
from repro_torch.sharding.mesh import make_mesh

SRC = os.path.join(os.path.dirname(__file__), "..", "src")
ROOT = os.path.join(os.path.dirname(__file__), "..")
SEQ, BATCH = 32, 8
KIND_SHAPE = {"train": "train_4k", "prefill": "prefill_32k",
              "decode": "decode_32k"}
XLA_FLAGS = ("--xla_force_host_platform_device_count=8 "
             "--xla_backend_optimization_level=0")
N_PROCS = 3
RANKS = 4                           # (pod 2, data 2): the batch's ranks


def _lowerings(arch):
    """(label, model overrides) of the analysis lowerings of ``arch``."""
    mc = tiny_of(arch)
    if mc.family == "encdec":
        return [(f"enc{e}/dec{d}", {"encoder_layers": e, "num_layers": d})
                for e, d in ((1, 1), (2, 1), (1, 2))]
    out = [("base", {"stage_override": (), "num_layers": 0})]
    for k, w, _, _ in R.layer_classes(mc):
        out.append((f"{k}/w{w}", {"stage_override": ((k, w, 1),),
                                  "num_layers": 1}))
    return out


LOWERINGS = [(a, kind, label, over) for a in ARCH_IDS
             for kind in KIND_SHAPE
             if KIND_SHAPE[kind] in supported_shapes(tiny_of(a))
             for label, over in _lowerings(a)]
FLOPS_CELLS = [(a, s, kind) for a in ARCH_IDS
               for s in supported_shapes(get_model_config(a))
               for kind in KIND_SHAPE]

REFERENCE = """
import dataclasses, json, re, sys
sys.path[:0] = [%r]
import jax
from repro.configs.base import (RunConfig, SHAPES, SINGLE_POD, resolve)
from repro.configs.tiny import tiny_of
from repro.launch import dryrun
from repro.launch import roofline
LOWERINGS, FLOPS_CELLS, SEQ, BATCH, KIND_SHAPE = %r, %r, %r, %r, %r
part, n = int(sys.argv[2]), int(sys.argv[3])
AUTO = jax.sharding.AxisType.Auto
meshes = {n: jax.make_mesh(shape, ("pod", "data", "model"),
                           axis_types=(AUTO,) * 3, devices=jax.devices()[:n])
          for n, shape in ((8, (2, 2, 2)), (1, (1, 1, 1)))}
HEAD = re.compile(r"^(?:ENTRY )?%%([\\w.\\-]+) .*\\{$")
INSTR = re.compile(r"^\\s*(?:ROOT )?%%([\\w.\\-]+) = (\\w+)\\[([0-9,]*)\\]")
CALL = re.compile(r"\\b(calls|to_apply|body|condition)=%%([\\w.\\-]+)")
TRIP = re.compile(r'"known_trip_count":\\{"n":"(\\d+)"\\}')


def dims(s):
    return [int(d) for d in s.split(",")] if s else []


def prod(xs):
    out = 1
    for x in xs:
        out *= x
    return out


def hlo_matmul_flops(text):
    # per device: each dot 2 x result x contracting size, each
    # convolution 2 x result x the kernel's size over its output features,
    # each computation weighted by the trips of the loops calling it
    shapes, comps, calls, cur, entry = {}, {}, {}, None, None
    for line in text.splitlines():
        h = HEAD.match(line)
        if h:
            cur = h.group(1)
            comps[cur], calls[cur] = [], []
            if line.startswith("ENTRY"):
                entry = cur
            continue
        m = INSTR.match(line)
        if m:
            shapes[m.group(1)] = dims(m.group(3))
        if cur is None:
            continue
        if m and (" dot(" in line or " convolution(" in line):
            comps[cur].append(line)
        trip = TRIP.search(line)
        for kind, callee in CALL.findall(line):
            k = int(trip.group(1)) if (kind == "body" and trip) else 1
            calls[cur].append((callee, k))
        bc = re.search(r"branch_computations=\\{([^}]*)\\}", line)
        if bc:
            calls[cur] += [(c.strip().lstrip("%%"), 1)
                           for c in bc.group(1).split(",")]
    mult = {}

    def visit(c, w):
        mult[c] = mult.get(c, 0) + w
        for callee, k in calls.get(c, ()):
            visit(callee, w * k)
    visit(entry, 1)
    total = 0
    for c, lines in comps.items():
        for line in lines:
            m = INSTR.match(line)
            res = prod(dims(m.group(3)))
            ops = re.findall(r"%%([\\w.\\-]+)",
                             line.split("(", 1)[1].split(")", 1)[0])
            if " dot(" in line:
                cd = re.search(r"lhs_contracting_dims=\\{([0-9,]*)\\}", line)
                lhs = shapes[ops[0]]
                k = prod(lhs[i] for i in dims(cd.group(1)))
            else:
                rhs = shapes[ops[1]]
                lab = re.search(r"dim_labels=\\w+_(\\w+)->", line).group(1)
                k = prod(rhs) // rhs[lab.index("o")]
            total += 2 * res * k * mult.get(c, 0)
    return total


out = {"lowerings": {}, "model_flops": {}}
if part == 0:
    for arch, shape, kind in FLOPS_CELLS:
        out["model_flops"]["/".join((arch, shape, kind))] = \\
            roofline.model_flops(resolve(arch, shape), kind)
for i, (arch, kind, label, over) in enumerate(LOWERINGS):
    if i %% n != part:
        continue
    sh = SHAPES[KIND_SHAPE[kind]]
    rc = RunConfig(model=tiny_of(arch), mesh=SINGLE_POD,
                   shape=dataclasses.replace(
                       sh, seq_len=SEQ,
                       global_batch=min(BATCH, sh.global_batch)))
    over = {k: tuple(tuple(s) for s in v) if k == "stage_override" else v
            for k, v in over.items()}
    mc = dataclasses.replace(rc.model, q_chunk=0, **over)
    tr = dataclasses.replace(rc.train, loss_chunk=10 ** 9, microbatch=0)
    rc = dataclasses.replace(rc, model=mc, train=tr)
    for n, mesh in meshes.items():
        lowered, _ = dryrun.build_lowered(rc, mesh, kind)
        text = lowered.compile().as_text()
        out["lowerings"]["/".join((arch, kind, label, str(n)))] = \\
            hlo_matmul_flops(text) * n
with open(sys.argv[1], "w") as f:
    json.dump(out, f)
""" % (SRC, LOWERINGS, FLOPS_CELLS, SEQ, BATCH, KIND_SHAPE)


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's model flops and its lowerings' matmul flops, in
    ``N_PROCS`` subprocesses side by side."""
    out = tmp_path_factory.mktemp("roofline")
    env = dict(os.environ, PYTHONPATH=SRC, JAX_PLATFORMS="cpu",
               XLA_FLAGS=XLA_FLAGS)
    procs = [subprocess.Popen([sys.executable, "-c",
                               textwrap.dedent(REFERENCE),
                               str(out / f"{i}.json"), str(i), str(N_PROCS)],
                              stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                              text=True, env=env) for i in range(N_PROCS)]
    got = {"lowerings": {}, "model_flops": {}}
    for i, p in enumerate(procs):
        o, e = p.communicate(timeout=400)
        assert p.returncode == 0, f"stdout:\n{o}\nstderr:\n{e[-4000:]}"
        with open(out / f"{i}.json") as f:
            part = json.load(f)
        for k in got:
            got[k].update(part[k])
    return got


def _tiny_rc(arch, kind, seq=SEQ, batch=BATCH, **model):
    sh = SHAPES[KIND_SHAPE[kind]]
    return RunConfig(model=dataclasses.replace(tiny_of(arch), **model),
                     shape=dataclasses.replace(
                         sh, seq_len=seq,
                         global_batch=min(batch, sh.global_batch)))


def _meta_mesh():
    return make_mesh((2, 2, 2), ("pod", "data", "model"), ["meta"] * 8)


@pytest.mark.parametrize("arch,shape,kind", FLOPS_CELLS)
def test_model_flops_equal_the_references(ref, arch, shape, kind):
    want = ref["model_flops"]["/".join((arch, shape, kind))]
    assert R.model_flops(resolve(arch, shape), kind) == want


def _by_design(arch, kind, label):
    """The port's counted flops beyond the reference's, by design (module
    note): the loss chunks' head recomputed in backward, and a moe decode
    step's groups of one rank's rows."""
    mc = tiny_of(arch)
    extra = 0
    if kind == "train" and mc.family != "encdec":
        extra += 2 * BATCH * SEQ * mc.d_model * mc.vocab_size
    if kind == "decode" and label.startswith("moe/"):
        from repro_torch.models.moe import capacity
        E, k, cf = mc.num_experts, mc.num_experts_per_tok, mc.capacity_factor
        slots = E * (RANKS * capacity(BATCH // RANKS, E, k, cf)
                     - capacity(BATCH, E, k, cf))
        extra += slots * 3 * 2 * mc.d_model * mc.moe_d_ff
    return extra


@pytest.mark.parametrize("arch,kind,label,over", LOWERINGS)
def test_matmul_flops_per_class_match_the_references_hlo(ref, arch, kind,
                                                         label, over):
    rc = R._analysis_rc(_tiny_rc(arch, kind), **over)
    mesh = make_mesh((2, 2, 1), ("pod", "data", "model"), ["meta"] * 4)
    got = R.count_cell(rc, mesh, kind)["flops"] * RANKS
    key = "/".join((arch, kind, label))
    one, eight = ref["lowerings"][key + "/1"], ref["lowerings"][key + "/8"]
    assert one > 0
    assert got - _by_design(arch, kind, label) == pytest.approx(one,
                                                                rel=0.01)
    # XLA repeats on both 'model' devices the products whose dims do not
    # split over 'model': the partitioned count only adds to the whole
    assert eight >= one


def _whole(rc, mesh, kind):
    got = R.count_cell(R._analysis_rc(rc), mesh, kind, cut=False)
    got["unique"] += 4 * got["cur"]
    return got


# every kind, the recurrences at more than three trips: xlstm's prefill at
# S 1024 (mLSTM chunks of 256: 4 trips; sLSTM 1024), its train step at S
# 64 (sLSTM 64), hymba at S 60 + 4 meta
# tokens in chunks of 16 (4 trips), and the mamba kind as a stage of its
# own beside it; whisper's encoder and decoder
COMBINE_CASES = (
    [(a, k, SEQ, {}) for a in ("h2o_danube_1_8b", "gemma3_4b",
                               "qwen3_moe_30b_a3b", "whisper_large_v3")
     for k in KIND_SHAPE]
    + [("xlstm_350m", k, 1024 if k == "prefill" else 64, {})
       for k in KIND_SHAPE]
    + [("hymba_1_5b", k, 60, {"ssd_chunk": 16}) for k in KIND_SHAPE]
    + [("hymba_1_5b", k, 60, {"ssd_chunk": 16, "num_layers": 3,
                               "stage_override": (("mamba", 0, 2),
                                                  ("hymba", 8, 1))})
       for k in KIND_SHAPE])


@pytest.mark.parametrize("arch,kind,seq,model", COMBINE_CASES)
def test_class_combination_equals_the_whole_model(arch, kind, seq, model):
    rc = _tiny_rc(arch, kind, seq=seq, batch=2, **model)
    mesh = _meta_mesh()
    counts = R.class_counts(rc, mesh, kind)
    tot = R.combine(counts)
    whole = _whole(rc, mesh, kind)
    assert {k: tot[k] for k in R._KEYS} == {k: whole[k] for k in R._KEYS}
    if arch == "xlstm_350m" and kind != "decode":
        assert {c[0]: c[3]["trips"] for c in counts["classes"]} == (
            {"mlstm/w0": 4, "slstm/w0": 1024} if kind == "prefill" else
            {"mlstm/w0": 1, "slstm/w0": 64})
    if model.get("ssd_chunk") and kind != "decode":
        assert all(c[3]["trips"] == 4 for c in counts["classes"])


def test_cut_trips_restores_the_loops():
    from repro_torch.models import ssm, xlstm
    before = (ssm.ssd_body, ssm.ssd_chunked, xlstm.slstm_step,
              xlstm.slstm_scan, xlstm.mlstm_chunk_body,
              xlstm.mlstm_chunkwise)
    with pytest.raises(RuntimeError, match="inside"):
        with R.cut_trips(2):
            assert ssm.ssd_body is not before[0]
            raise RuntimeError("inside")
    assert (ssm.ssd_body, ssm.ssd_chunked, xlstm.slstm_step,
            xlstm.slstm_scan, xlstm.mlstm_chunk_body,
            xlstm.mlstm_chunkwise) == before


def test_eager_bytes_on_a_hand_built_sequence():
    a = torch.empty(4, 8, device="meta")               # 128 B
    b = torch.empty(8, 2, dtype=torch.bfloat16, device="meta")  # 32 B
    with R.EagerBytes() as eb:
        t = a.t()                                      # view: 0
        c = t.contiguous()                             # clone: 128 + 128
        v = c.view(32)                                 # view: 0
        d = v * 2.0                                    # 128 + 128
        e = a.to(torch.bfloat16)                       # 128 + 64
        f = e @ b                                      # 64 + 32 + 16
        g = f.sum()                                    # 16 + 2
        a[0].add_(1.0)                                 # select 0; 32 + 32
    want = (256 + 256 + 192 + 112 + 18 + 64)
    assert eb.bytes == want
    assert d.shape == (32,) and g.shape == ()


def test_collective_bytes_equal_the_mesh_steps_traffic():
    """Tiny h2o-danube on (data 2, model 2) of four CPU entries: one
    ``make_spmd_train_step`` step's ``gathered``, ``reduce_scattered`` and
    ``all_reduced`` bytes (``local + moved``, summed over its computing
    coordinates: both 'model' coordinates of each rank) against the
    roofline's per-coordinate all-gather, reduce-scatter and all-reduce
    bytes x those coordinates, under ``_WIRE_FACTOR`` (x 1, x 1, x 2),
    at one microbatch and at two (each coordinate gathers every
    microbatch, the stacked leaves a layer at a time in forward and again
    in backward, the other leaves once), and at microbatches of one row,
    which do not split over the two ranks (the first rank's two
    coordinates compute)."""
    from repro_torch.data import make_train_batch
    from repro_torch.models import registry
    from repro_torch.optim import adamw_init
    from repro_torch.sharding.placement import shard_tree
    from repro_torch.sharding.rules import make_ctx
    from repro_torch.training import spmd
    for microbatch in (0, 2, 1):
        rc = RunConfig(model=tiny_of("h2o_danube_1_8b"),
                       shape=dataclasses.replace(SHAPES["train_4k"],
                                                 seq_len=16, global_batch=4),
                       train=TrainConfig(microbatch=microbatch,
                                         remat_policy="none"))
        mesh = make_mesh((2, 2), ("data", "model"), ["cpu"] * 4)
        ctx = make_ctx(mesh, "train")
        bundle = registry.build(rc, device="cpu")
        params = shard_tree(
            bundle.init_params(torch.Generator().manual_seed(0)),
            ctx.spec_tree_shardings(bundle.specs))
        bs = {k: ctx.sharding(s.shape, ("act_batch",) + (None,) * (s.ndim - 1))
              for k, s in bundle.input_specs("train").items()}
        step = spmd.make_spmd_train_step(bundle, rc, ctx)
        step(params, adamw_init(params), make_train_batch(rc, 0, "cpu", mesh,
                                                         bs))
        t = step.traffic
        got = R.collective_bytes(rc, make_mesh((2, 2), ("data", "model"),
                                               ["meta"] * 4), "train")
        n = got["ranks"]
        assert n == (2 if microbatch == 1 else 4)
        gathered = t["gathered"].local + t["gathered"].moved
        scattered = (t["reduce_scattered"].local
                     + t["reduce_scattered"].moved)
        reduced = t["all_reduced"].local + t["all_reduced"].moved
        assert gathered > 0 and scattered > 0 and reduced > 0
        assert got["by_kind"] == {"all-gather": gathered / n,
                                  "reduce-scatter": scattered / n,
                                  "all-reduce": 2 * reduced / n}
    rep = R.analyze_cell("h2o_danube_1_8b", "train_4k", verbose=False,
                         rc=rc, mesh=make_mesh((2, 2), ("data", "model"),
                                               ["meta"] * 4))
    assert rep["collective_bytes_per_device"] == (
        gathered / n + scattered / n + 2 * reduced / n)
    assert rep["link_bw"] == 450e9 and rep["devices"] == 4


@pytest.mark.parametrize("window,seq", [(8, 64), (0, 64), (100, 64)])
def test_kernel_gate_counts_the_band(window, seq):
    """With ``use_pallas_attn`` the scoring forward on ``meta`` counts the
    ``swattn`` kernel's band (the pair count of ``chip_smoke.py``'s
    kernel bound), where the plain ``attend`` counts full S x S products;
    nothing is launched and no launch is counted."""
    from torch.utils.flop_counter import FlopCounterMode
    from repro_torch.kernels.swattn import kernel as SW
    mc = dataclasses.replace(tiny_of("h2o_danube_1_8b"), attn_window=window,
                             num_layers=1)
    B, H, hd = 2, mc.num_heads, mc.resolved_head_dim()
    pairs = (window * (window + 1) // 2 + (seq - window) * window
             if 0 < window < seq else seq * (seq + 1) // 2)
    band = 4 * hd * pairs * H * B
    mesh = make_mesh((1, 1), ("data", "model"), ["meta"])
    flops = {}
    for gate in (False, True):
        rc = dataclasses.replace(
            _tiny_rc("h2o_danube_1_8b", "prefill", seq=seq, batch=B),
            model=dataclasses.replace(mc, use_pallas_attn=gate, q_chunk=0))
        before = SW.swattn.launches
        flops[gate] = R.count_cell(rc, mesh, "score")["flops"]
        assert SW.swattn.launches == before
    plain_attn = 4 * hd * seq * seq * H * B          # QK^T and PV, S x S
    assert flops[False] - flops[True] == plain_attn - band
    q = torch.empty(B, seq, H, hd, device="meta")
    kv = torch.empty(B, seq, mc.num_kv_heads, hd, device="meta")
    with FlopCounterMode(display=False) as fc:
        out = SW.swattn(q, kv, kv, window=window, scale=0.25)
    assert fc.get_total_flops() == band == SW.band_flops(q.shape, window)
    assert out.shape == q.shape and out.device.type == "meta"


def test_link_constants():
    from repro_torch.obs import roofline as obs
    assert (obs.NVLINK_BW, obs.INTER_NODE_BW, obs.NVLINK_DOMAIN) == (
        450e9, 50e9, 8)
    assert obs.link_bw(1) == obs.link_bw(8) == 450e9
    assert obs.link_bw(16) == obs.link_bw(256) == 50e9
    assert 197e12 not in obs.PEAK_OPS_PER_S.values()


def test_production_cell_through_the_cli(tmp_path):
    """``--arch h2o_danube_1_8b --shape train_4k`` on the 16 x 16 meta
    mesh, as a command with its own time limit: the reference's keys and
    the port's, bf16 compute at the H100's dense peak, the inter-node
    link, and the figures the dry run gives the same cell."""
    out = tmp_path / "r.json"
    env = dict(os.environ, PYTHONPATH=SRC, CUDA_VISIBLE_DEVICES="")
    r = subprocess.run([sys.executable, "-m", "repro_torch.launch.roofline",
                        "--arch", "h2o_danube_1_8b", "--shape", "train_4k",
                        "--out", str(out)], capture_output=True, text=True,
                       timeout=180, env=env, cwd=ROOT)
    assert r.returncode == 0, r.stderr
    assert "FAIL" not in r.stdout
    (rep,) = json.loads(out.read_text())
    assert set(rep) >= {
        "arch", "shape", "kind", "devices", "flops_per_device",
        "bytes_per_device", "collective_bytes_per_device", "compute_s",
        "memory_s", "collective_s", "dominant", "model_flops", "profile",
        "useful_ratio", "bound_step_s", "roofline_fraction",
        "coll_by_kind", "peak_ops", "hbm_bw", "link_bw", "counts"}
    assert rep["devices"] == 256 and rep["kind"] == "train"
    assert rep["peak_ops"] == 989e12 and rep["hbm_bw"] == 3.35e12
    assert rep["link_bw"] == 50e9
    assert rep["bound_step_s"] == max(rep["compute_s"], rep["memory_s"],
                                      rep["collective_s"])
    dr = dryrun.run_cell("h2o_danube_1_8b", "train_4k", False)
    assert rep["unique_bytes_per_device"] == (
        dr["memory"]["argument_bytes"] + dr["memory"]["output_bytes"])
    # the per-class combination of a 24-layer model against the dry run's
    # whole-model count (which runs the body's loss chunks and q chunks)
    assert rep["flops_per_device"] == pytest.approx(
        dr["matmul_flops_per_device"], rel=1e-9)
    assert rep["model_flops"] == R.model_flops(
        resolve("h2o_danube_1_8b", "train_4k"), "train")
    # every coordinate computes: the dry run's coordinate, its sums' bytes
    # on the wire (x 2) as the roofline's all-reduce
    assert rep["ranks"] == 256 and dr["tp_members"] == 16
    assert rep["coll_by_kind"]["all-reduce"] == (
        2 * dr["all_reduced_bytes_per_device"])


def test_profiles_on_the_production_meshes():
    """``profile='kv8'`` counts the int8 cache's quantise and dequantise
    traffic; ``profile='ep'`` builds the EP mesh (16 x 8 x 2 of ``meta``
    entries) with the experts' forced placement, and its train cell
    reckons one coordinate of the tensor-parallel step, against
    ``profile='dp'`` (``dp_only``: 'model' folded into the batch, a rank
    computes alone on 256 ranks)."""
    base = R.analyze_cell("yi_6b", "decode_32k", verbose=False)
    kv8 = R.analyze_cell("yi_6b", "decode_32k", verbose=False, profile="kv8")
    assert kv8["profile"] == "kv8" and base["profile"] == "default"
    assert kv8["flops_per_device"] == base["flops_per_device"]
    assert kv8["bytes_per_device"] > base["bytes_per_device"]
    assert kv8["unique_bytes_per_device"] < base["unique_bytes_per_device"]
    ep = R.analyze_cell("qwen3_moe_30b_a3b", "decode_32k", verbose=False,
                        profile="ep")
    assert ep["profile"] == "ep" and ep["devices"] == 256
    assert ep["link_bw"] == 50e9 and ep["collective_bytes_per_device"] > 0
    # to train, a coordinate's count: the group spans 'expert' and
    # 'model' (16 members: 32 heads split 16 ways, the experts 8 ways,
    # each block's first member computing it)
    tr = R.analyze_cell("qwen3_moe_30b_a3b", "train_4k", verbose=False,
                        profile="ep")
    assert tr["ranks"] == 256 and tr["coll_by_kind"]["all-reduce"] > 0
    whole = R.analyze_cell("qwen3_moe_30b_a3b", "train_4k", verbose=False,
                           profile="dp")
    assert whole["ranks"] == 256 and "all-reduce" not in whole[
        "coll_by_kind"]
