"""chip_smoke.py's control flow on the CPU: the device check, the
phase selection, and exiting before any result when there is no GPU.
(The phases themselves need the card.)"""

import types

import jax
import pytest

import chip_smoke


def _fake_devices(platform, count, kind="NVIDIA H100 80GB HBM3"):
    return [types.SimpleNamespace(platform=platform, device_kind=kind)
            for _ in range(count)]


def test_check_device_rejects_cpu():
    with pytest.raises(RuntimeError, match="needs a GPU"):
        chip_smoke.check_device(jax.devices())


def test_check_device_summary_and_count():
    devices = _fake_devices("gpu", 4)
    assert chip_smoke.check_device(devices) == {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": 4,
    }
    assert chip_smoke.check_device(devices, 4)["count"] == 4
    with pytest.raises(RuntimeError, match="expected 4 GPUs"):
        chip_smoke.check_device(_fake_devices("gpu", 1), 4)


@pytest.mark.parametrize("argv,expected", [
    (["--four-cards"], (chip_smoke.phase_four_cards,)),
    ([], chip_smoke.ONE_CARD_PHASES),
    (["--seed", "3"], chip_smoke.ONE_CARD_PHASES),
])
def test_phase_selection(argv, expected):
    assert chip_smoke.selected_phases(chip_smoke.parse_args(argv)) == \
        expected


def test_four_cards_excludes_one_card_phases():
    args = chip_smoke.parse_args(["--four-cards"])
    assert not set(chip_smoke.selected_phases(args)) & set(
        chip_smoke.ONE_CARD_PHASES)


def test_main_fails_on_cpu_before_any_result(capsys, monkeypatch):
    ran = []
    monkeypatch.setattr(chip_smoke, "ONE_CARD_PHASES",
                        (lambda ctx: ran.append(ctx),))
    monkeypatch.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    old = jax.config.jax_compilation_cache_dir
    try:
        with pytest.raises(RuntimeError, match="needs a GPU"):
            chip_smoke.main([])
    finally:
        jax.config.update("jax_compilation_cache_dir", old)
    assert ran == []
    assert '"ok"' not in capsys.readouterr().out
