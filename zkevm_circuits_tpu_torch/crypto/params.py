"""BN254 / auxiliary curve parameters.

Mirrors the parameter surface of halo2curves' `bn256` module (zkevm-circuits
uses `halo2_proofs` over BN254, SURVEY.md §2.3), re-derived with Python
ints; a copy of zkevm_circuits_tpu/crypto/params.py.

All constants are plain Python ints here; array-form constants are built in
`field.py` / `curve.py`.
"""

# --- BN254 (alt_bn128) ---------------------------------------------------
# Scalar field modulus r (a.k.a. Fr): order of G1/G2.
FR_MODULUS = 21888242871839275222246405745257275088548364400416034343698204186575808495617
# Base field modulus q (a.k.a. Fq): coordinate field of G1.
FQ_MODULUS = 21888242871839275222246405745257275088696311157297823662689037894645226208583

# BN curve parameter u (used by the pairing's Miller loop).
BN_U = 4965661367192848881

# Fr multiplicative generator and 2-adicity (r - 1 = 2^28 * T_ODD).
FR_TWO_ADICITY = 28
FR_GENERATOR = 7  # smallest multiplicative generator of Fr*
FR_T_ODD = (FR_MODULUS - 1) >> FR_TWO_ADICITY
# Primitive 2^28-th root of unity: g^T_ODD mod r.
FR_ROOT_OF_UNITY = pow(FR_GENERATOR, FR_T_ODD, FR_MODULUS)

# G1: y^2 = x^3 + 3 over Fq; generator (1, 2).
G1_B = 3
G1_GEN = (1, 2)

# G2: y^2 = x^3 + 3/(9+u) over Fq2 = Fq[u]/(u^2+1). Generator coordinates
# (c0, c1) pairs — standard alt_bn128 G2 generator (EIP-197).
G2_B = None  # computed in pairing.py (element of Fq2)
G2_GEN_X = (
    10857046999023057135944570762232829481370756359578518086990519993285655852781,
    11559732032986387107991004021392285783925812861821192530917403151452391805634,
)
G2_GEN_Y = (
    8495653923123431417604973247489272438418190587263600148770280649306958101930,
    4082367875863433681332203403145435568316851327593401208105741076214120093531,
)

# --- secp256k1 (for ECDSA sig witness, reference eth-types/src/sign_types.rs) ---
SECP_P = 2**256 - 2**32 - 977
SECP_N = 0xFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFFEBAAEDCE6AF48A03BBFD25E8CD0364141
SECP_GX = 0x79BE667EF9DCBBAC55A06295CE870B07029BFCDB2DCE28D959F2815B16F81798
SECP_GY = 0x483ADA7726A3C4655DA4FBFC0E1108A8FD17B448A68554199C47D08FFB10D4B8

# --- limb layout ----------------------------------------------------------
# Field elements are (..., N_DIGITS) uint8 arrays, little-endian base-2^8
# digits: the layout every public function of the port takes and returns.
DIGIT_BITS = 8
N_DIGITS = 32  # 256 bits
N_LIMBS_U16 = 16


def to_digits(x: int, n: int = N_DIGITS) -> list[int]:
    """Little-endian base-256 digits of x."""
    assert 0 <= x < (1 << (8 * n)), "value out of range"
    return [(x >> (8 * i)) & 0xFF for i in range(n)]


def from_digits(digits) -> int:
    return sum(int(d) << (8 * i) for i, d in enumerate(digits))
