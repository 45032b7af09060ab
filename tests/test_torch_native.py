"""The native host helpers of the port (``heat_tpu_torch.native``, copies of
``heat_tpu/native``): the click-file parser and the hit matrix against the
numpy paths and against the JAX package's copies, the numpy fallback and
the record of the path taken, and the CLI's ``--no-data-cache``."""

import os
import shutil

import numpy as np
import pytest
import yaml

from heat_tpu_torch import main as tmain
from heat_tpu_torch import native
from heat_tpu_torch.data import datasets as tdatasets
from heat_tpu_torch.evaluation import metrics as tmetrics


def _messy_file(path, seed=3, users=200):
    """Shuffled user order, id gaps, trailing separators, CRLF, empty and
    duplicate lines (the reference's ``tests/test_datasets.py`` recipe)."""
    rng = np.random.default_rng(seed)
    lines = []
    for u in rng.permutation(users):
        if rng.random() < 0.1:
            continue
        items = rng.integers(0, 5000, rng.integers(0, 30))
        line = " ".join([str(u)] + [str(i) for i in items])
        if rng.random() < 0.2:
            line += " "
        if rng.random() < 0.2:
            line += "\r"
        lines.append(line)
        if rng.random() < 0.05:
            lines.append("")
        if rng.random() < 0.05:
            lines.append(lines[-1] if lines[-1] else line)
    path.write_text("\n".join(lines) + "\n")
    return str(path)


@pytest.mark.parametrize("seed", [3, 4, 5])
def test_native_parser_matches_numpy_and_the_reference(tmp_path, seed):
    from heat_tpu.native import parse_click_file as jparse

    path = _messy_file(tmp_path / "messy.txt", seed=seed)
    got = native.parse_click_file(path)
    want = tdatasets._parse_lines_numpy(path, " ")
    ref = jparse(path)
    assert len(got) == len(want) == len(ref)
    for a, b, c in zip(got, want, ref):
        assert a.dtype == np.int32
        assert list(a) == list(b) == list(c)


def test_native_parser_takes_another_separator(tmp_path):
    path = tmp_path / "comma.txt"
    path.write_text("0,3,4\n2,1\n1\n")
    got = native.parse_click_file(str(path), ",")
    want = tdatasets._parse_lines_numpy(str(path), ",")
    assert [list(x) for x in got] == [list(x) for x in want] == [[3, 4], [], [1]]


@pytest.mark.parametrize("users,k", [(1, 5), (37, 20), (300, 50)])
def test_hits_matrix_matches_numpy_and_the_reference(users, k):
    from heat_tpu.native import hits_matrix as jhits

    rng = np.random.default_rng(users)
    top = rng.integers(0, 80, (users, k)).astype(np.int32)
    truth = [rng.choice(80, size=int(s), replace=False)
             for s in rng.integers(0, 12, users)]
    got = native.hits_matrix(top, truth)
    assert got.dtype == np.float64 and got.shape == (users, k)
    np.testing.assert_array_equal(got, jhits(top, truth))
    np.testing.assert_array_equal(got, tmetrics._hits_matrix(top, truth))
    assert native.PATHS["hits_matrix"] == "native"


def test_from_file_records_the_path_and_falls_back(tmp_path, monkeypatch):
    path = _messy_file(tmp_path / "clicks.txt")
    fast = tdatasets.ClickDataset.from_file(path, max_his=4, seed=7)
    assert native.PATHS["parse_click_file"] == "native"
    slow = tdatasets.ClickDataset.from_file(path, max_his=4, seed=7,
                                            use_native=False)
    assert native.PATHS["parse_click_file"] == "numpy"
    for f in ("pairs", "his_items", "masks"):
        np.testing.assert_array_equal(getattr(fast, f), getattr(slow, f))

    def broken(*args, **kwargs):
        raise OSError("no toolchain")

    monkeypatch.setattr(native, "parse_click_file", broken)
    monkeypatch.setattr(native, "hits_matrix", broken)
    again = tdatasets.ClickDataset.from_file(path, max_his=4, seed=7)
    assert native.PATHS["parse_click_file"] == "numpy"
    np.testing.assert_array_equal(again.pairs, fast.pairs)
    top = np.asarray([[1, 2, 3]], np.int32)
    np.testing.assert_array_equal(tmetrics._hits_matrix(top, [[3, 9]]),
                                  [[0.0, 0.0, 1.0]])
    assert native.PATHS["hits_matrix"] == "numpy"


def _sources_in(tmp_path, monkeypatch):
    """The two sources copied under ``tmp_path``, and the build directory
    pointed at ``tmp_path / "out"``; returns (sources, build directory)."""
    srcs = []
    for src in native._SRCS:
        shutil.copy(src, tmp_path / src.name)
        srcs.append(tmp_path / src.name)
    out = tmp_path / "out"
    monkeypatch.setattr(native, "BUILD_DIR", out)
    monkeypatch.setattr(native, "_SRCS", srcs)
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "_SO", native._SO)
    return srcs, out


def test_the_library_builds_into_build_and_again_when_a_source_is_newer(
        tmp_path, monkeypatch):
    """The build goes into the build directory, not beside the sources,
    under the name of its key; an edited source is another key and builds
    again (its age plays no part); a failed build leaves its error in
    BUILD_ERROR."""
    assert native._SO.parent == native.BUILD_DIR
    assert native.BUILD_DIR.parts[-2:] == ("build", "heat_tpu_torch")
    assert native._SO == native.library_path()
    srcs, out = _sources_in(tmp_path, monkeypatch)
    native._lib()
    first = native.library_path()
    built = os.stat(first).st_mtime_ns
    assert os.listdir(out) == [first.name] and native._SO == first
    monkeypatch.setattr(native, "_LIB", None)
    native._lib()  # up to date: not built again
    assert os.stat(first).st_mtime_ns == built
    past = os.stat(first).st_mtime - 10
    os.utime(srcs[0], (past, past))
    srcs[0].write_text(srcs[0].read_text() + "\n// edited\n")
    os.utime(srcs[0], (past, past))  # older than the library, and edited
    monkeypatch.setattr(native, "_LIB", None)
    native._lib()
    second = native.library_path()
    assert second != first and native._SO == second
    assert sorted(os.listdir(out)) == sorted([first.name, second.name])
    assert os.stat(first).st_mtime_ns == built
    srcs[1].write_text("this is not C++\n")
    monkeypatch.setattr(native, "_LIB", None)
    monkeypatch.setattr(native, "BUILD_ERROR", None)
    with pytest.raises(Exception):
        native._lib()
    assert "CalledProcessError" in native.BUILD_ERROR


@pytest.mark.parametrize("part", ["sources", "flags", "cpu"])
def test_the_library_name_changes_with_each_part_of_its_key(
        tmp_path, monkeypatch, part):
    srcs, out = _sources_in(tmp_path, monkeypatch)
    monkeypatch.setattr(native, "host_cpu", lambda: "cpu A; sse2 avx2")
    before = native.library_path()
    assert before.parent == out
    assert before.name.startswith("_heat_native_") and before.suffix == ".so"
    assert native.library_path() == before  # a function of its key alone
    if part == "sources":
        srcs[1].write_text(srcs[1].read_text() + " ")
    elif part == "flags":
        monkeypatch.setattr(native, "_FLAGS", (*native._FLAGS, "-DNDEBUG"))
    else:
        monkeypatch.setattr(native, "host_cpu", lambda: "cpu A; sse2 avx2 avx512f")
    assert native.library_path() != before


def test_the_host_cpu_is_read_from_cpuinfo_or_the_platform(tmp_path, monkeypatch):
    """The first processor's model name and flags; without them (no such
    file, or a file that names neither) ``platform`` tells the machine."""
    import platform

    info = tmp_path / "cpuinfo"
    info.write_text("processor\t: 0\nmodel name\t: Some  CPU\nflags\t\t: fpu  avx2\n"
                    "\nprocessor\t: 1\nmodel name\t: Other CPU\nflags\t\t: fpu\n")
    monkeypatch.setattr(native, "_CPUINFO", info)
    assert native.host_cpu() == "Some CPU; fpu avx2"
    other = tmp_path / "cpuinfo2"
    other.write_text(info.read_text().replace("avx2", "avx512f"))
    first = native.library_path()
    monkeypatch.setattr(native, "_CPUINFO", other)
    assert native.library_path() != first
    fallback = f"{platform.machine()}; {platform.processor()}"
    monkeypatch.setattr(native, "_CPUINFO", tmp_path / "missing")
    assert native.host_cpu() == fallback
    info.write_text("processor\t: 0\nBogoMIPS\t: 50.00\n")
    monkeypatch.setattr(native, "_CPUINFO", info)
    assert native.host_cpu() == fallback


def test_a_library_under_another_key_is_not_loaded(tmp_path, monkeypatch):
    """What another machine, other flags or other sources left in the build
    directory (here files that are no library at all, newer than the
    sources) is neither loaded nor removed: this host builds and loads its
    own."""
    srcs, out = _sources_in(tmp_path, monkeypatch)
    out.mkdir()
    monkeypatch.setattr(native, "host_cpu", lambda: "cpu B")
    foreign = native.library_path()
    monkeypatch.setattr(native, "host_cpu", lambda: "cpu A")
    unkeyed = out / "_heat_native.so"  # the name before the key
    for path in (foreign, unkeyed):
        path.write_bytes(b"not a shared library")
    mine = native.library_path()
    assert mine not in (foreign, unkeyed) and not mine.exists()
    native._lib()
    assert native._SO == mine and mine.exists()
    assert foreign.read_bytes() == unkeyed.read_bytes() == b"not a shared library"
    top = np.asarray([[1, 2, 3]], np.int32)
    np.testing.assert_array_equal(native.hits_matrix(top, [[3, 9]]), [[0.0, 0.0, 1.0]])
    # Under that other key the file it names is loaded, and it is no library.
    monkeypatch.setattr(native, "host_cpu", lambda: "cpu B")
    monkeypatch.setattr(native, "_LIB", None)
    with pytest.raises(OSError):
        native._lib()
    assert native._SO == foreign


def _dataset_config(tmp_path):
    """config0 pointed at a tiny click dataset under ``tmp_path``."""
    rng = np.random.default_rng(0)
    for name, n in (("train.txt", 8), ("test.txt", 2)):
        lines = [" ".join(map(str, [u] + list(rng.choice(60, n, replace=False))))
                 for u in range(40)]
        (tmp_path / name).write_text("\n".join(lines) + "\n")
    with open("benchmarks/AmazonBooks/config0.yaml") as f:
        cfg = yaml.safe_load(f)
    cfg["dataset_config"]["data_dir"] = str(tmp_path)
    path = tmp_path / "config.yaml"
    path.write_text(yaml.safe_dump(cfg))
    return str(path)


@pytest.mark.parametrize("no_cache", [True, False], ids=["no_data_cache", "cache"])
def test_no_data_cache_writes_no_sidecar(tmp_path, capsys, no_cache):
    config = _dataset_config(tmp_path)
    args = ["--config", config, "--epochs", "1", "--device", "cpu"]
    record = tmain.main(args + (["--no-data-cache"] if no_cache else []))
    capsys.readouterr()
    sidecars = sorted(p.name for p in tmp_path.glob("*.npz"))
    assert np.isfinite(record["losses"]).all()
    if no_cache:
        assert sidecars == []
    else:
        assert len(sidecars) == 2 and all(
            s.startswith(("train.txt.heat-", "test.txt.heat-")) for s in sidecars)
    assert native.PATHS["parse_click_file"] == "native"
