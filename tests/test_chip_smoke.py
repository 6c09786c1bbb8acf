"""chip_smoke.py and bench.py refuse to run without a GPU, and the smoke
test's last line has the fixed format the card run is judged by."""

import json
import os
import shutil
import subprocess
import sys

import pytest

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)

import chip_smoke  # noqa: E402


class _FakeDevice:
    platform = "gpu"
    device_kind = "NVIDIA H100 80GB HBM3"


def test_require_gpu_refuses_cpu():
    with pytest.raises(SystemExit, match="no GPU"):
        chip_smoke.require_gpu(1)


def test_main_prints_no_result_without_gpu(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main([])
    assert '"ok"' not in capsys.readouterr().out


def test_four_cards_refuses_cpu(capsys):
    with pytest.raises(SystemExit):
        chip_smoke.main(["--four-cards"])
    assert '"ok"' not in capsys.readouterr().out


@pytest.mark.parametrize("count", [1, 4])
def test_result_line_format(count):
    line = chip_smoke.result_line([_FakeDevice()] * count)
    assert "\n" not in line
    assert json.loads(line) == {
        "ok": True,
        "device": {"platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count},
    }


def test_alone_in_a_directory_fails(tmp_path):
    shutil.copy(os.path.join(ROOT, "chip_smoke.py"), tmp_path)
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    r = subprocess.run(
        [sys.executable, "chip_smoke.py"], cwd=tmp_path, env=env,
        capture_output=True, text=True, timeout=300,
    )
    assert r.returncode != 0
    assert '"ok"' not in r.stdout


def test_bench_refuses_cpu(monkeypatch):
    import bench

    monkeypatch.setattr(sys, "argv", ["bench.py", "cggi", "4"])
    with pytest.raises(SystemExit, match="no GPU"):
        bench.main()
