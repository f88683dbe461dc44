"""``InitOptions.profile_dir`` on the CPU: gstrf's numeric phase under
``torch.profiler`` (utils.perf.profile_trace), one Chrome trace JSON
file a call.

- One gstrf writes exactly one trace that parses as JSON and holds the
  factorization's host ops, on every route: the dense mega engine, the
  compressed store, the fused engine (nb > 256) and a 1 x 1 grid of a
  one-rank gloo group (its file named after the rank).
- A second gstrf after update_values writes a second file.
- A gstrf that raises leaves the profiler closed, so that the next trace
  opens.
- The factors are the bits of a run without profile_dir.
"""

import json
import socket

import numpy as np
import pytest
import torch
import torch.distributed as dist

from pangulu_tpu_torch import api
from pangulu_tpu_torch import InitOptions, gstrf, init, update_values
from pangulu_tpu_torch.models import poisson2d

ROUTES = {
    "mega": dict(nb=8),
    "compressed": dict(nb=8, tile_storage="compressed"),
    "fused": dict(nb=288),
    "mesh": dict(nb=8, mesh_shape=(1, 1)),
}


def _traces(d):
    return sorted(d.glob("*.pt.trace.json"))


def _factors(h):
    t = h.factor_tiles
    return t.to_dense() if api._compressed(h) else t.numpy()


@pytest.fixture
def one_rank_group():
    """A gloo group of one rank on a free localhost port."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        yield
    finally:
        dist.destroy_process_group()


@pytest.mark.parametrize("route", ROUTES)
def test_profile_dir_writes_one_trace_per_gstrf(tmp_path, request, route):
    if route == "mesh":
        request.getfixturevalue("one_rank_group")
    a = poisson2d(12)
    opts = dict(dtype="r64", ordering="rcm", device="cpu", **ROUTES[route])
    plain = init(a, InitOptions(**opts))
    gstrf(plain)
    h = init(a, InitOptions(profile_dir=str(tmp_path), **opts))
    gstrf(h)
    files = _traces(tmp_path)
    assert len(files) == 1
    trace = json.loads(files[0].read_text())
    names = {e.get("name") for e in trace["traceEvents"]}
    assert any(n and n.startswith("aten::") for n in names)
    if route == "mesh":
        assert "_rank0." in files[0].name
    np.testing.assert_array_equal(_factors(h), _factors(plain))
    # a refactorization writes its own file beside the first
    s = a.to_scipy().copy()
    s.data = s.data * 1.5
    update_values(h, s)
    gstrf(h)
    assert len(_traces(tmp_path)) == 2


def test_gstrf_that_raises_closes_the_trace(tmp_path, monkeypatch):
    class Broken(api.LUFactorizer):
        def factorize(self):
            raise RuntimeError("factorization failed")

    h = init(poisson2d(8), InitOptions(nb=8, device="cpu",
                                       profile_dir=str(tmp_path / "a")))
    with monkeypatch.context() as m:
        m.setattr(api, "LUFactorizer", Broken)
        with pytest.raises(RuntimeError, match="factorization failed"):
            gstrf(h)
    assert not torch.autograd._profiler_enabled()
    h.opts.profile_dir = str(tmp_path / "b")
    gstrf(h)
    assert len(_traces(tmp_path / "b")) == 1
