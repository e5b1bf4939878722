"""Config/flag system — same three-level precedence semantics as the reference
(CLI > experiment JSON > defaults.json): ``update_config`` (utils.py:42-84,
including the ``logical_op="OR"`` store_true-flag rule) and recursive
``fill_with_defaults`` (utils.py:193-201). Behavior-compatible, own
implementation (pinned by tests/test_config.py)."""

from __future__ import annotations


def _fmt_value(v) -> str:
    if isinstance(v, dict):
        return dict2str(v)
    if isinstance(v, (list, tuple)):
        return "_".join(str(u) for u in v)
    if isinstance(v, float):
        return f"{v:.0e}"
    return str(v)


def dict2str(d) -> str:
    """Flatten a (possibly nested) dict into an underscore-joined run tag,
    floats in exponent form (capability of reference utils.py:13-25)."""
    return "_".join(f"{k}_{_fmt_value(v)}" for k, v in d.items())


def _read(source, key, fallback):
    """Dict-like containers (config dicts) read via .get; everything else
    (argparse Namespace) via attribute access."""
    if hasattr(source, "get"):
        return source.get(key, fallback)
    return getattr(source, key, fallback)


def _write(target, key, value):
    if hasattr(target, "__setitem__"):
        target[key] = value
    else:
        setattr(target, key, value)


def update_config(
    old_name,
    new_name=None,
    old_config=None,
    new_config=None,
    default=None,
    logical_op=None,
):
    """Resolve one field with CLI-over-config precedence and write the winner
    back into ``old_config``.

    The CLI value (``new_config.new_name``) wins unless it is None, in which
    case the config value (``old_config.old_name``) stands. For booleans,
    ``logical_op`` encodes how argparse store_true/store_false flags interact
    with the config: ``"OR"`` means a False flag is "not given" (config wins;
    the effective value is flag OR config), ``"AND"`` symmetrically for True.
    """
    cli_value = _read(new_config, new_name or old_name, default)
    cli_wins = cli_value is not None
    if cli_wins and logical_op is not None and isinstance(cli_value, bool):
        if logical_op == "OR":
            cli_wins = cli_value
        elif logical_op == "AND":
            cli_wins = not cli_value
        else:
            raise NotImplementedError(logical_op)
    value = cli_value if cli_wins else _read(old_config, old_name, default)
    _write(old_config, old_name, value)
    return value


def fill_with_defaults(config: dict, defaults: dict) -> None:
    """Deep-merge defaults into config in place; an explicit JSON ``null`` in
    the experiment config counts as unset (capability of utils.py:193-201)."""
    for key, default in defaults.items():
        if isinstance(default, dict):
            # an explicit null must be replaced, not recursed into
            # (setdefault would hand the recursion a None)
            if config.get(key) is None:
                config[key] = {}
            fill_with_defaults(config[key], default)
        elif config.get(key) is None:
            config[key] = default
