"""The port's CLIs accept every flag of the root CLIs they stand in for.

The root ``train.py`` and ``generate.py`` build their parsers under
``__main__``, so their options are read here from the source with ``ast``:
every ``add_argument`` call, its option string, and whether it takes a value
(``store_true``), a choice or a number. Each one, with a value of its kind,
must parse through the port's ``build_parser`` (``vdiff_tpu_torch.train``,
``vdiff_tpu_torch.generate``), as must the port's own ``--device``. Imports
nothing of JAX."""

import ast
import os

import pytest

pytest_plugins = ["torch_limits"]

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
REQUIRED = {"train": ["--config-path", "c.json"],
            "generate": ["--config-path", "c.json", "--ckpt-path", "m.pt"]}


def _root_options(cli):
    """(option string, argv value list) of every add_argument call in the
    root ``{cli}.py``."""
    with open(os.path.join(REPO, f"{cli}.py")) as f:
        tree = ast.parse(f.read())
    options = []
    for node in ast.walk(tree):
        if not (isinstance(node, ast.Call) and isinstance(node.func, ast.Attribute)
                and node.func.attr == "add_argument"):
            continue
        flag = node.args[0].value
        kw = {k.arg: k.value for k in node.keywords}
        if "action" in kw and kw["action"].value == "store_true":
            value = []
        elif "choices" in kw:
            value = [ast.literal_eval(kw["choices"])[0]]
        elif "type" in kw and kw["type"].id in ("int", "float"):
            value = ["1"]
        else:
            value = ["x"]
        options.append((flag, value))
    return options


CASES = [(cli, flag, value) for cli in ("train", "generate") for flag, value in _root_options(cli)]


def test_the_root_parsers_were_read():
    """Both root CLIs' option lists were found (a rename would empty them)."""
    flags = {cli: {f for c, f, _ in CASES if c == cli} for cli in ("train", "generate")}
    assert {"--train-device", "--eval-device", "--prng-impl", "--remat"} <= flags["train"]
    assert {"--progressive", "--pred-freq", "--device", "--eta"} <= flags["generate"]
    assert len(flags["train"]) > 50 and len(flags["generate"]) > 15


@pytest.mark.parametrize("cli,flag,value", CASES, ids=[f"{c}{f}" for c, f, _ in CASES])
def test_port_parser_accepts_the_root_flag(cli, flag, value):
    import importlib

    parser = importlib.import_module(f"vdiff_tpu_torch.{cli}").build_parser()
    args = parser.parse_args(REQUIRED[cli] + [flag, *value])
    parsed = getattr(args, flag.lstrip("-").replace("-", "_"))
    if value:  # the value as given, or the number it converts to
        assert str(parsed) in (value[0], "1.0"), parsed
    else:
        assert parsed is True


@pytest.mark.parametrize("cli", ["train", "generate"])
def test_port_parser_takes_device(cli):
    import importlib

    parser = importlib.import_module(f"vdiff_tpu_torch.{cli}").build_parser()
    assert parser.parse_args(REQUIRED[cli]).device == "cuda"
    assert parser.parse_args(REQUIRED[cli] + ["--device", "cpu"]).device == "cpu"
