"""The port's examples beside the reference's, on the CPU: where the
reference's example prints a number that both packages compute on the same
data, both examples run (concurrently, in subprocesses; the port's with
``--device cpu``) and the numbers are compared: the DMatrix modes'
decisions and the exact modes' AUCs, and the serving example's page,
chunk, hit-rate and byte counts beside its bit-for-bit agreements."""
import re

from torch_examples_run import _finish, _run, _start


def test_dmatrix_modes_match_reference():
    ref = _start("dmatrix_modes.py", "--quick", jax=True)
    out = _run("torch_dmatrix_modes.py", "--quick")
    want = _finish(ref)

    def modes(text):
        return {m.group(1): (m.group(2), m.group(3)) for m in re.finditer(
            r"^\s*(\w+): resolved mode=(\w+)(?: f=\S+)?\s+auc=(\S+)", text, re.M)}

    got, exp = modes(out), modes(want)
    assert set(got) == {"auto", "in_core", "out_of_core", "sampled"} == set(exp)
    for name in ("auto", "in_core", "out_of_core"):  # the exact modes: same cuts, same trees
        assert got[name] == exp[name], (name, got[name], exp[name])
    assert got["sampled"][0] == exp["sampled"][0] == "sampled"  # draws differ, decisions not
    header = re.compile(r"^IterDMatrix: (\d+) rows x (\d+) features, (\d+) pages", re.M)
    assert header.search(out).groups() == header.search(want).groups()
    assert "auc_delta vs forced = 0.000000" in out


def test_serve_paged_matches_reference():
    ref = _start("serve_paged.py", "--quick", jax=True)
    out = _run("torch_serve_paged.py", "--quick")
    want = _finish(ref)
    assert "all serving paths agree bit-for-bit" in out

    def counts(text):
        # the lines both compute on the same data, less their timings
        lines = [ln for ln in text.splitlines()
                 if ln.startswith(("trained", "paged forest", "shared-budget", "BatchServer"))
                 or "bit-for-bit" in ln]
        return [re.sub(r", overlap ratio \S+\)", ")", ln) for ln in lines]

    assert counts(out) == counts(want)
    assert len(counts(out)) >= 6
