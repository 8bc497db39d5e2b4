"""The GHS interval kernel's CUDA source run on the CPU.

g++ compiles ``csrc/ghs_superstep.cu`` against ``tests/cuda_host``'s
stand-ins for the CUDA runtime: one host thread a CUDA thread,
``__syncwarp``, ``__syncthreads`` and grid syncs as barriers, a warp's
votes and shuffles as collectives of its 32 threads.  From the same state,
the compiled kernel and its plain version ``ref.interval`` run an interval
at a time, and every ``ShardState`` array and the scalar vector must be
equal after each (exact equality): rmat-6 under the three lookup methods,
both lane counts, the relaxed Test queue on and off, both round loops, at
1, 2 and 4 shards, and from states that overflow the Test queue or miss
the edge hash.  Host threads interleave freely, so a lane that reads a
word another lane writes without a ``__syncwarp`` between them, or lanes
that part at a collective, show here as on the card: a difference, or a
barrier that times out.  Each case runs in a child process with a time
limit; the build is skipped where the machine has no g++."""
import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.join(os.path.dirname(__file__), "..")
SRC = os.path.join(ROOT, "src")
HOST = os.path.join(os.path.dirname(__file__), "cuda_host")
KERNEL = os.path.join(SRC, "repro_torch", "kernels", "csrc",
                      "ghs_superstep.cu")
# The kernel's shared-memory declarations, as each host block's.
SHARED = {"extern __shared__ int32_t smem[];":
          "int32_t* smem = host_block->smem.data();",
          "__shared__ int32_t sums[2];":
          "int32_t* sums = host_block->sums;"}

CHILD = r'''
import ctypes, json, sys
import numpy as np, torch
from repro_torch.core import generators, ghs_state, runtime
from repro_torch.core.params import GHSParams
from repro_torch.kernels.ghs_superstep import ghs_superstep, ref

lib = ctypes.CDLL(sys.argv[1])
lib.ghs_superstep_interval.argtypes = [
    ctypes.POINTER(ghs_superstep._Args)] + [ctypes.c_int] * 4 + [
    ctypes.c_void_p]
spec = json.loads(sys.argv[2])
params = GHSParams(**spec["knobs"])
S = spec["shards"]
g = generators.rmat(6, seed=8)
if S > 1:
    g = runtime.vertex_partitioned(g, params.partitioner, S)
topo, shards = ghs_state.host_shards(g, S, params, history_capacity=4096)
arrays = shards[0]
dst = 2 if topo.lanes == 5 else 4
if spec["force"] == "full_test_ring":
    arrays["tq_tail"] = np.int32(topo.qcap)
    arrays["tq"][:] = arrays["mq"][0]
elif spec["force"] == "miss":
    lv = int(arrays["mq"][0, dst])
    nbrs = set(arrays["nbr"][arrays["indptr"][lv]:
                             arrays["indptr"][lv + 1]].tolist())
    u = next(x for x in range(topo.num_vertices) if x not in nbrs and x != lv)
    arrays["inbox"][0, 0] = ghs_state.encode_messages(
        topo.lanes, ghs_state.CONNECT, 0, 0, np.uint32(u), np.uint32(lv),
        0, 0)[0]
    arrays["in_cnt"][0] = 1
cfg = ref.config(topo, params)
host = ghs_state.upload_stacked(shards, "cpu")
plain = ghs_state.upload_stacked(shards, "cpu")
n_steps = 1 if params.round_loop == "host" else cfg.check
scal_h = torch.zeros(3, dtype=torch.int32)
scal_p = scal_h.clone()
for k in range(spec["max_intervals"]):
    out = torch.zeros(3, dtype=torch.int32)
    xchg = torch.zeros(2 * S * S + 4 * S, dtype=torch.int32)
    args = ghs_superstep._Args(
        *[getattr(host, f).data_ptr() for f in ghs_state.ShardState._fields],
        scal_h.data_ptr(), out.data_ptr(), xchg.data_ptr(), cfg.block,
        cfg.qcap, cfg.ocap, cfg.xcap, cfg.tsize, host.hist_act.shape[1],
        n_steps, cfg.check, cfg.empty_needed, host.nbr.shape[1], S)
    assert lib.ghs_superstep_interval(
        ctypes.byref(args), ref.METHODS.index(cfg.method), cfg.lanes,
        int(cfg.relaxed), 64, None) == 0
    scal_h = out
    scal_p = ref.interval(plain, scal_p, n_steps, cfg)
    got, want = ghs_state.host_arrays(host), ghs_state.host_arrays(plain)
    bad = [f for f in want if not np.array_equal(got[f], want[f])]
    assert not bad and scal_h.tolist() == scal_p.tolist(), (k, bad)
    _, silent, err = scal_p.tolist()
    if err or silent >= cfg.empty_needed:
        break
print(json.dumps(dict(intervals=k + 1, err=err,
                      processed=int(want["n_processed"].sum()))))
'''

CASES = {
    "s1-default": (1, {}, None),
    "s1-linear-8-strict": (1, dict(use_hashing=False, compress_messages=False,
                                   relaxed_test_queue=False), None),
    "s1-binary-host": (1, dict(use_hashing=False, hash_table_factor=-1.0,
                               round_loop="host"), None),
    "s1-check7": (1, dict(check_frequency=7), None),
    "s2-default": (2, {}, None),
    "s4-8-strict-host": (4, dict(compress_messages=False,
                                 relaxed_test_queue=False,
                                 round_loop="host"), None),
    "s1-full-test-ring": (1, {}, "full_test_ring"),
    "s1-miss-binary": (1, dict(use_hashing=False, hash_table_factor=-1.0),
                       "miss"),
}


@pytest.fixture(scope="module")
def host_kernel(tmp_path_factory):
    """The kernel source compiled by g++ against tests/cuda_host."""
    if shutil.which("g++") is None:
        pytest.skip("needs g++")
    out = tmp_path_factory.mktemp("ghs_host_threads")
    with open(KERNEL) as f:
        source = f.read()
    for decl, host in SHARED.items():
        assert source.count(decl) == 1, decl
        source = source.replace(decl, host)
    kernel = out / "ghs_superstep_host.cu"
    kernel.write_text(source)
    lib = out / "libghs_superstep_host.so"
    subprocess.run(
        ["g++", "-std=c++20", "-O1", "-fPIC", "-shared", "-pthread",
         f"-I{HOST}", f'-DKERNEL_SOURCE="{kernel}"', "-o", str(lib),
         os.path.join(HOST, "launch.cpp")],
        check=True, capture_output=True, text=True, timeout=300)
    return str(lib)


@pytest.mark.parametrize("case", list(CASES))
def test_kernel_on_host_threads_equals_plain(host_kernel, case):
    shards, knobs, force = CASES[case]
    spec = dict(shards=shards, knobs=knobs, force=force,
                max_intervals=40 if force else 1000)
    env = dict(os.environ, PYTHONPATH=SRC)
    out = subprocess.run([sys.executable, "-c", CHILD, host_kernel,
                          json.dumps(spec)], env=env, capture_output=True,
                         text=True, timeout=240)
    assert out.returncode == 0, out.stderr[-3000:]
    res = json.loads(out.stdout.strip().splitlines()[-1])
    assert res["processed"] > 0
    want_err = {"full_test_ring": 1, "miss": 2}.get(force, 0)
    assert res["err"] == want_err, res
