"""The port's user tools against the JAX package's: ``tools/torch_im2rec.py``
writes the JAX ``tools/im2rec.py``'s ``.lst`` byte for byte and its
records (equal at ``--resize 0``; within the C.2 resize bound,
``assert_resized_close``, at ``--resize`` > 0), and
``tools/torch_launch.py -n 2`` starts a gloo job that joins with torch's
variables and with the ``DMLC_*`` ones (the port's
``init_process_group``), and kills a job past its ``--timeout``."""
import importlib.util
import os
import subprocess
import sys

import numpy as np
import pytest
from PIL import Image

from torch_port_helpers import assert_resized_close

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOOLS = os.path.join(REPO, "tools")
JOB_TIMEOUT = 60  # a two-rank job here takes 5-10 s


def _load(name):
    spec = importlib.util.spec_from_file_location(
        "_tools_" + name, os.path.join(TOOLS, name + ".py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.fixture(scope="module")
def image_tree(tmp_path_factory):
    """Two class folders of seeded RGB images (JPEG and PNG), and a stray
    file that is not an image."""
    root = tmp_path_factory.mktemp("imgs")
    rng = np.random.RandomState(5)
    for c, name in enumerate(("cat", "dog")):
        os.makedirs(root / name)
        for i in range(3):
            h, w = 20 + 3 * i, 28 - 2 * i
            a = (rng.rand(h, w, 3) * 255).astype(np.uint8)
            ext = ".png" if i == 1 else ".jpg"
            Image.fromarray(a).save(root / name / ("im%d%s" % (i, ext)))
    (root / "cat" / "notes.txt").write_text("not an image")
    return root


@pytest.mark.parametrize("recursive", [True, False])
def test_list_is_the_jax_list(image_tree, tmp_path, recursive):
    root = str(image_tree / "cat") if not recursive else str(image_tree)
    theirs, mine = _load("im2rec"), _load("torch_im2rec")
    assert theirs.make_list(str(tmp_path / "j"), root, recursive) == \
        mine.make_list(str(tmp_path / "t"), root, recursive)
    assert (tmp_path / "j.lst").read_bytes() == \
        (tmp_path / "t.lst").read_bytes()


def _records(prefix):
    from mxnet_tpu_torch import recordio

    rec = recordio.MXIndexedRecordIO(prefix + ".idx", prefix + ".rec", "r")
    try:
        return [rec.read_idx(i) for i in sorted(rec.keys)]
    finally:
        rec.close()


@pytest.mark.parametrize("resize", [0, 16])
def test_records_match_the_jax_tool(image_tree, tmp_path, resize):
    from mxnet_tpu_torch import recordio

    theirs, mine = _load("im2rec"), _load("torch_im2rec")
    root = str(image_tree)
    for tag, mod in (("j", theirs), ("t", mine)):
        mod.make_list(str(tmp_path / tag), root, recursive=True)
        assert mod.make_record(str(tmp_path / tag), root, quality=95,
                               resize=resize) == 6
    j, t = _records(str(tmp_path / "j")), _records(str(tmp_path / "t"))
    assert len(j) == len(t) == 6
    for a, b in zip(j, t):
        ha, ia = recordio.unpack_img(a)
        hb, ib = recordio.unpack_img(b)
        assert (ha.flag, ha.label, ha.id, ha.id2) == \
            (hb.flag, hb.label, hb.id, hb.id2)
        if resize == 0:
            assert a == b
        else:
            assert ia.shape[:2] == (resize, resize)
            assert_resized_close(ib, ia, share=0.08)


_JOB = r'''
import os, sys
import numpy as np
import torch
import torch.distributed as dist
out = sys.argv[1]
if sys.argv[2] == "torch":
    for k in [k for k in os.environ if k.startswith("DMLC_")]:
        del os.environ[k]
    dist.init_process_group("gloo", init_method="env://")
else:
    for k in ("MASTER_ADDR", "MASTER_PORT", "WORLD_SIZE", "RANK"):
        del os.environ[k]
    sys.path.insert(0, sys.argv[3])
    from mxnet_tpu_torch.parallel import distributed
    distributed.init_process_group(device="cpu", timeout_s=60)
x = torch.tensor([float(dist.get_rank() + 1)])
dist.all_reduce(x)
np.save(os.path.join(out, "rank%d.npy" % dist.get_rank()),
        np.array([dist.get_rank(), dist.get_world_size(),
                  int(os.environ["LOCAL_RANK"]), x.item()]))
dist.destroy_process_group()
'''


@pytest.mark.parametrize("variables", ["torch", "dmlc"])
def test_launch_starts_a_gloo_job(tmp_path, variables):
    script = tmp_path / "job.py"
    script.write_text(_JOB)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("DMLC_", "MASTER_", "JAX", "XLA"))}
    env["OMP_NUM_THREADS"] = "1"
    r = subprocess.run([sys.executable, os.path.join(TOOLS, "torch_launch.py"),
                        "-n", "2", "--timeout", str(JOB_TIMEOUT),
                        sys.executable, str(script), str(tmp_path),
                        variables, REPO],
                       env=env, capture_output=True, text=True,
                       timeout=JOB_TIMEOUT + 30)
    assert r.returncode == 0, r.stderr[-3000:]
    got = sorted(np.load(tmp_path / ("rank%d.npy" % i)).tolist()
                 for i in range(2))
    assert got == [[0, 2, 0, 3.0], [1, 2, 1, 3.0]]


def test_launch_kills_a_job_past_its_timeout(tmp_path):
    r = subprocess.run([sys.executable, os.path.join(TOOLS, "torch_launch.py"),
                        "-n", "2", "--timeout", "2", sys.executable, "-c",
                        "import time; time.sleep(60)"],
                       capture_output=True, text=True, timeout=30)
    assert r.returncode == 124


def test_launch_environment_holds_both_contracts():
    launch = _load("torch_launch")
    env = launch.worker_env({"KEEP": "1"}, 1, 4, "10.0.0.1:1234",
                            ["EXTRA=x"])
    assert env["KEEP"] == "1" and env["EXTRA"] == "x"
    assert (env["DMLC_PS_ROOT_URI"], env["DMLC_PS_ROOT_PORT"],
            env["DMLC_NUM_WORKER"], env["DMLC_WORKER_ID"]) == \
        ("10.0.0.1", "1234", "4", "1")
    assert (env["MASTER_ADDR"], env["MASTER_PORT"], env["WORLD_SIZE"],
            env["RANK"], env["LOCAL_RANK"]) == \
        ("10.0.0.1", "1234", "4", "1", "1")
