"""chip_smoke.py's command line on the CPU: --checks names only known
kernel checks, and without a CUDA device the script exits non-zero before
it prints a result line, whatever it was asked to run."""
import pytest

import chip_smoke


def test_unknown_check_is_refused(capsys):
    with pytest.raises(SystemExit) as e:
        chip_smoke.main(["--checks", "q6k,bogus"])
    assert e.value.code != 0
    assert "bogus" in capsys.readouterr().err


@pytest.mark.parametrize("argv", [[], ["--checks", "q6k,q5k", "--paths", "q4_k_m,q5_k_m"]])
def test_no_card_no_result(argv, capsys):
    assert chip_smoke.main(argv) != 0
    assert '"ok"' not in capsys.readouterr().out


# the checks of the kernels on the shared f32 body: K1, K4, K6, K7, K8, K9
@pytest.mark.parametrize("check", ["qmm", "q6k", "q4_0", "q5k", "legacy", "q23k"])
def test_checks_cover_k4_and_k7_row_invariance(check):
    assert check in chip_smoke.CHECKS
    names = chip_smoke.CHECKS[check].__code__.co_names
    assert "TILED_MS" in names and "check_rows" in names
    assert chip_smoke.TILED_MS[-1] == 128 and 100 in chip_smoke.TILED_MS
    assert set(chip_smoke.ROW_MS) == {1, 8, 16, 63, 100}
