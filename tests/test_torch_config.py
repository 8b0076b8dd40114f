"""Port config parity: every conf/*.cfg parses to equal fields in bpvo_tpu and
bpvo_tpu_torch, and ``params_from_jax`` carries parameters across."""
import dataclasses
import enum
import glob
import os

import pytest

from bpvo_tpu.config import AlgorithmParameters as JaxParams
from bpvo_tpu_torch.config import AlgorithmParameters, ConfigFile
from bpvo_tpu_torch.utils.convert import params_from_jax

CONF_DIR = os.path.join(os.path.dirname(os.path.dirname(
    os.path.abspath(__file__))), "conf")
CONFIGS = sorted(glob.glob(os.path.join(CONF_DIR, "*.cfg")))


def _plain(p):
    """asdict with enum members replaced by their string values."""
    return {k: (v.value if isinstance(v, enum.Enum) else v)
            for k, v in dataclasses.asdict(p).items()}


def test_configs_exist():
    assert len(CONFIGS) >= 5


@pytest.mark.parametrize("cfg", CONFIGS, ids=os.path.basename)
def test_config_file_parses_equal(cfg):
    assert (_plain(AlgorithmParameters.from_config_file(cfg))
            == _plain(JaxParams.from_config_file(cfg)))


@pytest.mark.parametrize("cfg", CONFIGS, ids=os.path.basename)
def test_params_from_jax_round_trips(cfg):
    jp = JaxParams.from_config_file(cfg)
    tp = params_from_jax(dataclasses.asdict(jp))
    assert tp == AlgorithmParameters.from_config_file(cfg)
    assert _plain(tp) == _plain(jp)


def test_defaults_equal_and_replace():
    assert _plain(AlgorithmParameters()) == _plain(JaxParams())
    p = AlgorithmParameters().replace(maxIterations=7)
    assert p.maxIterations == 7 and p != AlgorithmParameters()


def test_config_file_get_and_save(tmp_path):
    cf = ConfigFile()
    cf.set("maxIterations", "12").set("descriptor", "BitPlanes")
    path = str(tmp_path / "x.cfg")
    cf.save(path)
    back = ConfigFile(path)
    assert back.get("MAXITERATIONS", 0, int) == 12
    assert AlgorithmParameters.from_config(back).maxIterations == 12


def test_port_does_not_import_jax():
    """The package, its distributed layer included, must import in a
    process without jax."""
    import subprocess
    import sys
    code = ("import sys, bpvo_tpu_torch\n"
            "from bpvo_tpu_torch.vo import device_vo\n"
            "from bpvo_tpu_torch.utils import convert\n"
            "from bpvo_tpu_torch.data import synthetic\n"
            "from bpvo_tpu_torch.parallel import (bundle_adjustment, "
            "collectives, dryrun, multihost, pose_graph, sharded, "
            "sharded_vo, worker)\n"
            "from bpvo_tpu_torch.apps import scaling_bench\n"
            "assert 'jax' not in sys.modules and 'bpvo_tpu' not in sys.modules")
    subprocess.run([sys.executable, "-c", code], check=True,
                   cwd=os.path.dirname(CONF_DIR))
