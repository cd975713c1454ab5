"""chip_smoke.py at a tiny size on the CPU.

The smoke's phases, data and comparisons run here exactly as on the card,
at 40 samples x 2 chromosomes x 64 snarls; ``main`` itself must refuse to
run without a GPU.
"""

import os
import shutil
import subprocess
import sys

import numpy as np
import pytest

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

import chip_smoke as cs  # noqa: E402

TINY = cs.Sizes(n_samples=40, snarls_per_chrom=64, n_chroms=2, subset=48,
                perm_check=32, n_check=16, perms=8, graph_snarls=200,
                graph_samples=10, kinship_rank=10)
PHASES = ["1 ", "2 ", "3 ", "4 ", "5 ", "6 ", "7 ", "8 "]


@pytest.fixture(scope="module")
def smoke(tmp_path_factory):
    work = str(tmp_path_factory.mktemp("smoke"))
    data = cs.make_data(work, TINY, seed=0)
    results = cs.run_phases(data, TINY, 0, work,
                            log=cs.phase_logger("cpu"))
    return data, work, results


@pytest.mark.parametrize("prefix", PHASES)
def test_phase_matches_reference(smoke, prefix):
    _, _, results = smoke
    [res] = [r for r in results if r.name.startswith(prefix)]
    assert res.tally.compared > 0
    assert res.tally.mismatches == []
    assert res.wall_s > 0


def test_planted_mismatch_is_caught(smoke):
    data, work, _ = smoke
    full = data["full"]
    wanted = {"binary": cs.pick_snarls(full["snarl"], TINY.n_check,
                                       np.random.default_rng(1))}
    ref = cs.Reference(full, wanted)
    rows = cs._read_rows(os.path.join(work, "out", "dual",
                                      "binary_table_vcf.tsv"))
    clean = cs.Tally()
    cs.check_binary(clean, ref, "binary", rows)
    assert clean.compared > 0 and clean.mismatches == []

    sid = next(s.snarl_id_str for _, s in ref.snarls["binary"]
               if s.snarl_id_str in rows and rows[s.snarl_id_str][6] != "NA")
    p = float(rows[sid][6])
    rows[sid][6] = cs.fmt(p * 1.01 if p < 0.5 else p * 0.99)
    planted = cs.Tally()
    cs.check_binary(planted, ref, "binary", rows)
    assert len(planted.mismatches) == 1
    assert sid in planted.mismatches[0]


@pytest.mark.parametrize("got,want,kind", [
    ("0.1234", 0.12341, "ok"),
    ("NA", float("nan"), "ok"),
    ("1.2340e-05", 1.234e-05, "ok"),
    ("0.1235", 0.12344999999995, "flip"),
    ("0.1235", 0.1234, "mismatch"),
    ("0.1234", float("nan"), "mismatch"),
    (None, 0.5, "mismatch"),
    ("3:4,5:6", "3:4,5:6", "ok"),
    ("3:4,5:7", "3:4,5:6", "mismatch"),
])
def test_classify(got, want, kind):
    assert cs.classify(got, want) == kind


def test_four_card_path_on_virtual_devices(smoke):
    """The --four-cards comparison on the conftest's virtual CPU mesh."""
    import jax
    data, work, _ = smoke
    assert jax.device_count() > 1
    log = cs.phase_logger("cpu")
    logged = []
    results = cs.run_four_cards(data, TINY, os.path.join(work, "four"),
                                log=lambda x: (logged.append(x), log(x)))
    assert [r.name[:2] for r in results] == ["1 ", "2 ", "6 "]
    for res in results:
        assert res.tally.compared > 0 and res.tally.mismatches == []
    assert logged[0].startswith("unsharded tail compile seconds")


def _run_smoke(cwd, script):
    env = dict(os.environ, JAX_PLATFORMS="cpu")
    env.pop("PYTHONPATH", None)
    return subprocess.run([sys.executable, script], cwd=cwd, env=env,
                          capture_output=True, text=True, timeout=300)


def test_main_refuses_without_gpu(tmp_path):
    res = _run_smoke(tmp_path, os.path.join(REPO, "chip_smoke.py"))
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "no GPU" in res.stderr


def test_main_fails_outside_the_repo(tmp_path):
    shutil.copy(os.path.join(REPO, "chip_smoke.py"), tmp_path)
    res = _run_smoke(tmp_path, "chip_smoke.py")
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
