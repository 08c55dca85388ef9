"""Embedded network configurations and config.yaml loading.

The role of lighthouse/common/eth2_network_config (embedded
config.yaml + deposit-contract metadata per named network, selected with
`--network`) and eth2_config's spec-from-yaml path: a named registry of
(preset, ChainSpec) pairs plus a loader for consensus-spec-style
`config.yaml` files (the subset of keys this framework models; unknown
keys are ignored like the reference's `extra_fields`).
"""

from __future__ import annotations

import dataclasses
import pathlib

from .types import MAINNET_SPEC, MINIMAL_SPEC, ChainSpec

# config.yaml key -> (ChainSpec field, decoder)
def _hex(v) -> bytes:
    if isinstance(v, int):  # yaml parses unquoted 0x... as an integer
        return v.to_bytes(4, "big")
    return bytes.fromhex(str(v).removeprefix("0x"))


_int = int
_CONFIG_KEYS = {
    "GENESIS_FORK_VERSION": ("genesis_fork_version", _hex),
    "ALTAIR_FORK_VERSION": ("altair_fork_version", _hex),
    "ALTAIR_FORK_EPOCH": ("altair_fork_epoch", _int),
    "BELLATRIX_FORK_VERSION": ("bellatrix_fork_version", _hex),
    "BELLATRIX_FORK_EPOCH": ("bellatrix_fork_epoch", _int),
    "SECONDS_PER_SLOT": ("seconds_per_slot", _int),
    "MIN_GENESIS_ACTIVE_VALIDATOR_COUNT": ("min_genesis_active_validator_count", _int),
    "MIN_GENESIS_TIME": ("min_genesis_time", _int),
    "GENESIS_DELAY": ("genesis_delay", _int),
    "MIN_VALIDATOR_WITHDRAWABILITY_DELAY": ("min_validator_withdrawability_delay", _int),
    "SHARD_COMMITTEE_PERIOD": ("shard_committee_period", _int),
    "EJECTION_BALANCE": ("ejection_balance", _int),
    "MIN_PER_EPOCH_CHURN_LIMIT": ("min_per_epoch_churn_limit", _int),
    "CHURN_LIMIT_QUOTIENT": ("churn_limit_quotient", _int),
}

#: named networks (eth2_network_config's HARDCODED_NETS). The reference
#: embeds mainnet/gnosis/sepolia/holesky configs; this framework models
#: the mainnet + minimal(-preset interop) pair its presets support.
NETWORKS: dict[str, tuple[str, ChainSpec]] = {
    "mainnet": ("mainnet", MAINNET_SPEC),
    "minimal": ("minimal", MINIMAL_SPEC),
    # the interop/devnet profile: minimal preset with all forks at genesis
    "interop-merge": (
        "minimal",
        dataclasses.replace(MINIMAL_SPEC, altair_fork_epoch=0, bellatrix_fork_epoch=0),
    ),
}


def network_config(name: str) -> tuple[str, ChainSpec]:
    """-> (preset_name, ChainSpec) for a named network."""
    try:
        return NETWORKS[name]
    except KeyError:
        raise ValueError(
            f"unknown network {name!r} (have: {sorted(NETWORKS)})"
        ) from None


def resolve_spec(
    preset_name: str, network: str | None, testnet_dir: str | None
) -> tuple[str, ChainSpec | None]:
    """Shared --network/--testnet-dir resolution for CLI commands:
    a named network supplies (preset, base spec); a testnet dir's
    config.yaml overrides on top of that base (or the preset default).
    Returns (preset_name, spec-or-None); None means 'use the preset
    default'. BN and VC MUST resolve identically or duty signatures land
    in the wrong fork domains."""
    spec = None
    if network is not None:
        preset_name, spec = network_config(network)
    if testnet_dir:
        base = spec
        if base is None:
            base = MINIMAL_SPEC if preset_name == "minimal" else MAINNET_SPEC
        spec = load_config_yaml(pathlib.Path(testnet_dir) / "config.yaml", base=base)
    return preset_name, spec


def load_config_yaml(path: str | pathlib.Path, base: ChainSpec | None = None) -> ChainSpec:
    """Apply a consensus-spec config.yaml onto `base` (default: mainnet
    spec). Unknown keys are ignored; known keys are type-checked by their
    decoders."""
    import yaml

    raw = yaml.safe_load(pathlib.Path(path).read_text()) or {}
    if not isinstance(raw, dict):
        raise ValueError("config.yaml must be a mapping")
    overrides = {}
    for key, value in raw.items():
        hit = _CONFIG_KEYS.get(str(key))
        if hit is None:
            continue  # extra_fields: preserved-by-ignoring
        field_name, decode = hit
        overrides[field_name] = decode(value)
    return dataclasses.replace(base or MAINNET_SPEC, **overrides)


def dump_config_dict(spec: ChainSpec) -> dict[str, str]:
    """The modeled config keys as the Beacon API's string-valued mapping
    (the /eth/v1/config/spec payload)."""
    out: dict[str, str] = {}
    for yaml_key, (field_name, _decode) in _CONFIG_KEYS.items():
        value = getattr(spec, field_name)
        out[yaml_key] = "0x" + value.hex() if isinstance(value, bytes) else str(value)
    return out


def dump_config_yaml(spec: ChainSpec) -> str:
    """Inverse of load_config_yaml for the keys this framework models."""
    out = []
    for yaml_key, value in dump_config_dict(spec).items():
        if value.startswith("0x"):
            value = f"'{value}'"  # quoted: yaml must not int-parse it
        out.append(f"{yaml_key}: {value}")
    return "\n".join(out) + "\n"
