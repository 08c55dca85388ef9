"""The port's key management (crypto/aes.py, keystore.py, key_derivation.py,
wallet.py and validator_client/lockfile.py) against the JAX package's on
the CPU.

Published known answers pin both packages to the algorithms: EIP-2333's
master and child keys, NIST SP 800-38A F.5.1's AES-128-CTR stream and
FIPS-197's block, and EIP-2335's pbkdf2 keystore (c = 262,144, its
Unicode password). Seeded inputs (numpy) go through both packages and
compare byte for byte: derived keys, keystores that each package
encrypts and the other decrypts under both KDFs, the keystore JSON once
the salt, IV and UUID are fixed, password normalisation, and a wallet's
sequential validators. The keystore cipher runs under both branches
(the `cryptography` wheel, and the pure AES) where the wheel is
installed. The lockfile refuses a second holder, from either package
and from another process."""

import importlib
import json
import subprocess
import sys
import types
import uuid

import numpy as np
import pytest

SMALL_PBKDF2 = {"c": 2**10, "dklen": 32}
SMALL_SCRYPT = {"n": 2**10, "r": 8, "p": 1, "dklen": 32}
SMALL_KDF = {"pbkdf2": SMALL_PBKDF2, "scrypt": SMALL_SCRYPT}


def package(name: str):
    m = lambda mod: importlib.import_module(f"{name}.{mod}")  # noqa: E731
    return types.SimpleNamespace(name=name, aes=m("crypto.aes"), keystore=m("crypto.keystore"),
                                 kd=m("crypto.key_derivation"), wallet=m("crypto.wallet"),
                                 lockfile=m("validator_client.lockfile"), ref=m("crypto.bls.ref.api"))


JAX, PORT = package("lighthouse_tpu"), package("lighthouse_tpu_torch")

EIP2333_SEED = bytes.fromhex(
    "c55257c360c07c72029aebc1b53c05ed0362ada38ead3e3e9efa3708e53495531f09a698"
    "7599d18264c1e1c92f2cf141630c7a3c4ab7c81b2f001698e7463b04"
)
EIP2333_MASTER_SK = 6083874454709270928345386274498605044986640685124978867557563392430687146096
EIP2333_CHILD_SK = 20397789859736650942317412262472558107875392172444076792671091975210932703118

# EIP-2335's pbkdf2 test vector: the keystore, its password and the secret
EIP2335_PASSWORD = "\U0001d531\U0001d522\U0001d530\U0001d531\U0001d52d\U0001d51e\U0001d530\U0001d530\U0001d534" \
                   "\U0001d52c\U0001d52f\U0001d521\U0001f511"
EIP2335_SECRET = bytes.fromhex("000000000019d6689c085ae165831e934ff763ae46a2a6c172b3f1b60a8ce26f")
EIP2335_PUBKEY = "9612d7a727c9d0a22e185a1c768478dfe919cada9266988cb32359c11f2b7b27f4ae4040902382ae2910c15e2b420d07"
EIP2335_PBKDF2 = {
    "crypto": {
        "kdf": {"function": "pbkdf2", "params": {
            "dklen": 32, "c": 262144, "prf": "hmac-sha256",
            "salt": "d4e56740f876aef8c010b86a40d5f56745a118d0906a34e69aec8c0db1cb8fa3"}, "message": ""},
        "checksum": {"function": "sha256", "params": {},
                     "message": "8a9f5d9912ed7e75ea794bc5a89bca5f193721d30868ade6f73043c6ea6febf1"},
        "cipher": {"function": "aes-128-ctr", "params": {"iv": "264daa3f303d7259501c93d997d84fe6"},
                   "message": "cee03fde2af33149775b7223e7845e4fb2c8ae1792e5f99fe9ecf474cc8c16ad"},
    },
    "pubkey": EIP2335_PUBKEY,
    "path": "m/12381/60/0/0",
    "uuid": "64625def-3331-4eea-ab6f-782f3ed16a83",
    "version": 4,
}


def seeded_bytes(rng, n: int) -> bytes:
    return rng.integers(0, 256, size=n, dtype=np.uint8).tobytes()


def cipher_branch(monkeypatch, have_cryptography: bool) -> None:
    """Both packages' keystores on one AES branch: the `cryptography` wheel
    or the pure `aes.aes128_ctr`."""
    if have_cryptography and not PORT.keystore._HAVE_CRYPTOGRAPHY:
        pytest.skip("the cryptography wheel is not installed")
    for P in (PORT, JAX):
        monkeypatch.setattr(P.keystore, "_HAVE_CRYPTOGRAPHY", have_cryptography)


BRANCHES = pytest.mark.parametrize("have_cryptography", [False, True], ids=["pure", "cryptography"])


def test_eip2333_known_answer():
    for P in (PORT, JAX):
        master = P.kd.derive_master_sk(EIP2333_SEED)
        assert master == EIP2333_MASTER_SK
        assert P.kd.derive_child_sk(master, 0) == EIP2333_CHILD_SK


def test_derive_path_matches_on_seeded_seeds():
    """EIP-2334 signing and withdrawal paths from seeded seeds: the same
    keys in both packages, each in range; the same refusals."""
    rng = np.random.default_rng(2333)
    for i in range(3):
        seed = seeded_bytes(rng, 32 + 16 * i)
        for path in (PORT.kd.validator_signing_path(i), PORT.kd.validator_withdrawal_path(i), "m/0"):
            assert path in (JAX.kd.validator_signing_path(i), JAX.kd.validator_withdrawal_path(i), "m/0")
            sk = PORT.kd.derive_path(seed, path)
            assert sk == JAX.kd.derive_path(seed, path) and 0 < sk < PORT.kd.R
    for P in (PORT, JAX):
        with pytest.raises(ValueError, match="at least 32 bytes"):
            P.kd.derive_master_sk(b"short")
        with pytest.raises(ValueError, match="must start with m"):
            P.kd.derive_path(EIP2333_SEED, "x/1")
        with pytest.raises(ValueError, match="index out of range"):
            P.kd.derive_child_sk(EIP2333_MASTER_SK, 2**32)


def test_aes128_known_answers_and_seeded_streams():
    """FIPS-197 C.1's block and SP 800-38A F.5.1's CTR stream in both
    packages; seeded keys, IVs and lengths (partial last blocks, a counter
    that wraps) give the same stream in both, and the wheel's where it is
    installed."""
    key = bytes.fromhex("000102030405060708090a0b0c0d0e0f")
    for P in (PORT, JAX):
        assert P.aes.encrypt_block(key, bytes.fromhex("00112233445566778899aabbccddeeff")) == \
            bytes.fromhex("69c4e0d86a7b0430d8cdb78070b4c55a")
    key = bytes.fromhex("2b7e151628aed2a6abf7158809cf4f3c")
    iv = bytes.fromhex("f0f1f2f3f4f5f6f7f8f9fafbfcfdfeff")
    pt = bytes.fromhex("6bc1bee22e409f96e93d7e117393172a" "ae2d8a571e03ac9c9eb76fac45af8e51"
                       "30c81c46a35ce411e5fbc1191a0a52ef" "f69f2445df4f9b17ad2b417be66c3710")
    ct = bytes.fromhex("874d6191b620e3261bef6864990db6ce" "9806f66b7970fdff8617187bb9fffdff"
                       "5ae4df3edbd5d35e5b4f09020db03eab" "1e031dda2fbe03d1792170a0f3009cee")
    for P in (PORT, JAX):
        assert P.aes.aes128_ctr(key, iv, pt) == ct and P.aes.aes128_ctr(key, iv, ct) == pt
        assert P.aes.aes128_ctr(key, iv, pt[:23]) == ct[:23]
    rng = np.random.default_rng(38)
    for n in (0, 1, 16, 32, 33, 77):
        k, v, data = seeded_bytes(rng, 16), seeded_bytes(rng, 16), seeded_bytes(rng, n)
        got = PORT.aes.aes128_ctr(k, v, data)
        assert got == JAX.aes.aes128_ctr(k, v, data)
        wrapped = PORT.aes.aes128_ctr(k, b"\xff" * 16, data)
        assert wrapped == JAX.aes.aes128_ctr(k, b"\xff" * 16, data)
        if PORT.keystore._HAVE_CRYPTOGRAPHY:
            assert PORT.keystore._aes128ctr(k, v, data) == got
            assert PORT.keystore._aes128ctr(k, b"\xff" * 16, data) == wrapped


@BRANCHES
def test_eip2335_pbkdf2_vector_at_its_count(monkeypatch, have_cryptography):
    """EIP-2335's pbkdf2 keystore (c = 262,144) decrypts in both packages
    to the vector's secret, whose public key is the vector's; a keystore
    the port writes at that count decrypts in the JAX package."""
    cipher_branch(monkeypatch, have_cryptography)
    for P in (PORT, JAX):
        assert P.keystore.decrypt(EIP2335_PBKDF2, EIP2335_PASSWORD) == EIP2335_SECRET
    assert PORT.ref.SecretKey.from_bytes(EIP2335_SECRET).public_key().to_bytes().hex() == EIP2335_PUBKEY
    store = PORT.keystore.encrypt(EIP2335_SECRET, EIP2335_PASSWORD, pubkey=EIP2335_PUBKEY, kdf_function="pbkdf2")
    assert store["crypto"]["kdf"]["params"]["c"] == 262144
    assert JAX.keystore.decrypt(store, EIP2335_PASSWORD) == EIP2335_SECRET


@BRANCHES
@pytest.mark.parametrize("kdf", ["pbkdf2", "scrypt"])
def test_keystores_decrypt_across_packages(monkeypatch, kdf, have_cryptography):
    """Seeded secrets: each package decrypts what the other encrypts, under
    either KDF; a wrong password, an unknown version, cipher or KDF fail
    in both with the same message."""
    cipher_branch(monkeypatch, have_cryptography)
    rng = np.random.default_rng(2335)
    for i in range(2):
        secret = seeded_bytes(rng, 32)
        for src, dst in ((PORT, JAX), (JAX, PORT)):
            store = src.keystore.encrypt(secret, f"pass {i}", path=f"m/12381/3600/{i}/0/0", kdf_function=kdf,
                                         kdf_params=SMALL_KDF[kdf])
            assert dst.keystore.decrypt(store, f"pass {i}") == secret
            assert store["crypto"]["kdf"]["function"] == kdf and store["version"] == 4
    bad = {
        "password": (store, "wrong"),
        "version": ({**store, "version": 3}, f"pass {i}"),
        "cipher": ({**store, "crypto": {**store["crypto"], "cipher": {**store["crypto"]["cipher"],
                                                                     "function": "aes-256-gcm"}}}, f"pass {i}"),
        "kdf": ({**store, "crypto": {**store["crypto"], "kdf": {**store["crypto"]["kdf"], "function": "argon2"}}},
                f"pass {i}"),
    }
    for what, (ks, password) in bad.items():
        messages = []
        for P in (PORT, JAX):
            with pytest.raises(ValueError) as e:
                P.keystore.decrypt(ks, password)
            assert type(e.value).__name__ == "KeystoreError", what
            messages.append(str(e.value))
        assert messages[0] == messages[1], what


def fix_randomness(monkeypatch, seed: int) -> None:
    """Both packages' keystore and wallet draw the same salts, IVs and seeds
    (`secrets.token_bytes`) and UUIDs (`uuid.uuid4`) from one seed each."""
    for P in (PORT, JAX):
        rng = np.random.default_rng(seed)
        ids = np.random.default_rng(seed + 1)
        fixed_secrets = types.SimpleNamespace(token_bytes=lambda n, rng=rng: seeded_bytes(rng, n))
        fixed_uuid = types.SimpleNamespace(uuid4=lambda ids=ids: uuid.UUID(bytes=seeded_bytes(ids, 16), version=4))
        for module in (P.keystore, P.wallet):
            monkeypatch.setattr(module, "secrets", fixed_secrets)
            monkeypatch.setattr(module, "_uuid", fixed_uuid)


@BRANCHES
@pytest.mark.parametrize("kdf", ["pbkdf2", "scrypt"])
def test_keystore_json_is_byte_identical(monkeypatch, tmp_path, kdf, have_cryptography):
    """With the salt, IV and UUID drawn from one seed in both packages, the
    keystores are the same JSON byte for byte, and so are the files
    `save` writes; `load` reads either back."""
    cipher_branch(monkeypatch, have_cryptography)
    fix_randomness(monkeypatch, 7)
    secret = seeded_bytes(np.random.default_rng(11), 32)
    stores = [P.keystore.encrypt(secret, "p\u00e4ss", path="m/12381/3600/5/0/0", pubkey="ab" * 48,
                                 kdf_function=kdf, kdf_params=SMALL_KDF[kdf]) for P in (PORT, JAX)]
    assert json.dumps(stores[0], sort_keys=True) == json.dumps(stores[1], sort_keys=True)
    files = []
    for P, store in zip((PORT, JAX), stores):
        path = tmp_path / f"{P.name}.json"
        P.keystore.save(store, str(path))
        files.append(path.read_bytes())
        assert JAX.keystore.load(str(path)) == PORT.keystore.load(str(path)) == store
        assert not (tmp_path / f"{P.name}.json.tmp").exists()
    assert files[0] == files[1]


def test_password_normalisation_matches():
    """EIP-2335: NFKD, then C0, C1 and Delete control codes dropped; the
    same bytes in both packages, and a password decrypts a keystore made
    under any of its equivalent spellings."""
    cases = ["password", "pass\x7fword", "\x00pass\x1fword\x9f", "p\u00e4ss", "pa\u0308ss", "\uff50\uff41ss",
             EIP2335_PASSWORD, "\u212b\u00c5A\u030a", ""]
    for pw in cases:
        assert PORT.keystore._normalize_password(pw) == JAX.keystore._normalize_password(pw), repr(pw)
    assert PORT.keystore._normalize_password(EIP2335_PASSWORD) == "testpassword\U0001f511".encode()
    assert PORT.keystore._normalize_password("pass\x7fword\x85") == b"password"
    secret = b"\x01" * 32
    store = PORT.keystore.encrypt(secret, "pass\x7fword", kdf_function="pbkdf2", kdf_params=SMALL_PBKDF2)
    assert JAX.keystore.decrypt(store, "password") == secret
    store = JAX.keystore.encrypt(secret, "p\u00e4ss", kdf_function="pbkdf2", kdf_params=SMALL_PBKDF2)
    assert PORT.keystore.decrypt(store, "pa\u0308ss") == secret


def test_wallet_sequential_validators_match(monkeypatch):
    """A wallet from a seeded seed in each package: the same JSON once the
    randomness is fixed; the next validators 0, 1, 2 with the same
    keystores, keys equal to `derive_path` on the signing paths, and
    each package's wallet seed decrypted by the other."""
    fix_randomness(monkeypatch, 23)
    seed = seeded_bytes(np.random.default_rng(2386), 32)
    wallets = [P.wallet.Wallet.create("w", "wallet pw", seed=seed, kdf_params=SMALL_PBKDF2) for P in (PORT, JAX)]
    assert json.dumps(wallets[0].data, sort_keys=True) == json.dumps(wallets[1].data, sort_keys=True)
    assert wallets[0].decrypt_seed("wallet pw") == wallets[1].decrypt_seed("wallet pw") == seed
    assert JAX.wallet.Wallet(wallets[0].data).decrypt_seed("wallet pw") == seed
    for want in range(3):
        made = [w.next_validator("wallet pw", "key pw", kdf_params=SMALL_PBKDF2) for w in wallets]
        (ks_port, i_port), (ks_jax, i_jax) = made
        assert i_port == i_jax == want and ks_port["path"] == ks_jax["path"] == f"m/12381/3600/{want}/0/0"
        assert json.dumps(ks_port, sort_keys=True) == json.dumps(ks_jax, sort_keys=True)
        sk = int.from_bytes(JAX.keystore.decrypt(ks_port, "key pw"), "big")
        assert sk == PORT.kd.derive_path(seed, ks_port["path"])
    assert wallets[0].data["nextaccount"] == wallets[1].data["nextaccount"] == 3
    with pytest.raises(ValueError, match="checksum"):
        wallets[0].next_validator("wrong", "key pw", kdf_params=SMALL_PBKDF2)


def test_lockfile_refuses_a_second_holder(tmp_path):
    """A held lock refuses a second holder from either package and from
    another process; release keeps the file; a dead holder's leftover file
    does not block; both packages' errors read alike."""
    path = tmp_path / "voting-keystore.json.lock"
    code = ("import sys; from lighthouse_tpu_torch.validator_client.lockfile import Lockfile, LockfileError\n"
            "try:\n    Lockfile(sys.argv[1]).acquire()\nexcept LockfileError as e:\n    print(e)\n"
            "else:\n    print('acquired')\n")
    import pathlib

    root = pathlib.Path(__file__).resolve().parent.parent
    for holder, other in ((PORT, JAX), (JAX, PORT)):
        lock = holder.lockfile.Lockfile(path).acquire()
        messages = []
        for P in (PORT, JAX):
            with pytest.raises(P.lockfile.LockfileError) as e:
                P.lockfile.Lockfile(path).acquire()
            messages.append(str(e.value))
        assert messages[0] == messages[1] and "is locked by process" in messages[0]
        out = subprocess.run([sys.executable, "-c", code, str(path)], cwd=root, capture_output=True, text=True,
                             timeout=60, check=True).stdout
        assert "is locked by process" in out, out
        lock.release()
        assert path.exists()
        with other.lockfile.Lockfile(path):
            pass
    path.write_text("999999999")
    for P in (PORT, JAX):
        with P.lockfile.Lockfile(path):
            assert path.read_text().strip().isdigit() and path.read_text().strip() != "999999999"
