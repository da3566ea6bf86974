"""BLS12-381 curve constants.

Role model: the reference drand's crypto dependency chain
(`key/curve.go:24-43` -> drand/kyber-bls12381 -> kilic/bls12-381).  We
re-derive every non-primary constant (cofactors, Frobenius coefficients,
twist order) programmatically from the primary parameters below, and
runtime-verify the derivations in tests, because this build runs with zero
network egress (no external test vectors).

Primary parameters (public knowledge of the BLS12-381 curve):
  - p: base field prime
  - r: scalar field prime (order of G1/G2)
  - x: the BLS parameter (p and r are polynomials in x)
"""

# Base field prime.
P = 0x1A0111EA397FE69A4B1BA7B6434BACD764774B84F38512BF6730D2A0F6B0F6241EABFFFEB153FFFFB9FEFFFFFFFFAAAB

# Subgroup order (scalar field).
R = 0x73EDA753299D7D483339D80809A1D80553BDA402FFFE5BFEFFFFFFFF00000001

# BLS parameter x (negative).  p = (x-1)^2/3 * r + x,  r = x^4 - x^2 + 1.
X = -0xD201000000010000

# Curve: E/Fp : y^2 = x^3 + 4.  Twist: E'/Fp2 : y^2 = x^3 + 4*(1+u).
B_G1 = 4
B_G2 = (4, 4)  # 4*(1+u) as an Fp2 element (c0, c1)

# Generators (standard, from the BLS12-381 specification).
G1_GEN_X = 0x17F1D3A73197D7942695638C4FA9AC0FC3688C4F9774B905A14E3A3F171BAC586C55E83FF97A1AEFFB3AF00ADB22C6BB
G1_GEN_Y = 0x08B3F481E3AAA0F1A09E30ED741D8AE4FCF5E095D5D00AF600DB18CB2C04B3EDD03CC744A2888AE40CAA232946C5E7E1

G2_GEN_X = (
    0x024AA2B2F08F0A91260805272DC51051C6E47AD4FA403B02B4510B647AE3D1770BAC0326A805BBEFD48056C8C121BDB8,
    0x13E02B6052719F607DACD3A088274F65596BD0D09920B61AB5DA61BBDC7F5049334CF11213945D57E5AC7D055D042B7E,
)
G2_GEN_Y = (
    0x0CE5D527727D6E118CC9CDC6DA2E351AADFD9BAA8CBDD3A76D429A695160D12C923AC9CC3BACA289E193548608B82801,
    0x0606C4A02EA734CC32ACD2B02BC28B99CB3E287E85A763AF267492AB572E99AB3F370D275CEC1DA1AAA9075FF05F79BE,
)

# Trace of Frobenius over Fp:  #E(Fp) = p + 1 - t,  t = x + 1 for BLS curves.
T_FROB = X + 1

# Group orders, derived.
N_E_FP = P + 1 - T_FROB           # #E(Fp)
H1 = N_E_FP // R                  # G1 cofactor
assert N_E_FP % R == 0

# t2 = t^2 - 2p: the trace of Frobenius over Fp2.
T2 = T_FROB * T_FROB - 2 * P

# Sextic twist orders: t2^2 - 4 p^2 = -3 f^2; the two sextic twists have
# orders p^2 + 1 - (t2 + 3f)/2 and p^2 + 1 - (t2 - 3f)/2.  Exactly one is
# divisible by r; that one is E' (the twist used by BLS12-381 G2).
def _twist_order():
    d = 4 * P * P - T2 * T2
    assert d % 3 == 0
    f2 = d // 3
    f = _isqrt(f2)
    assert f * f == f2
    for cand in (P * P + 1 - (T2 + 3 * f) // 2, P * P + 1 - (T2 - 3 * f) // 2):
        if cand % R == 0:
            return cand
    raise AssertionError("no sextic twist order divisible by r")


def _isqrt(n: int) -> int:
    import math
    return math.isqrt(n)


N_TWIST = _twist_order()
H2 = N_TWIST // R                 # G2 cofactor

# Domain separation tags: drand's exact wire suites (the DSTs kilic/bls12-381
# applies behind `chain/verify.go:38-45` / `key/curve.go:24-43`).
DST_G2 = b"BLS_SIG_BLS12381G2_XMD:SHA-256_SSWU_RO_NUL_"
DST_G1 = b"BLS_SIG_BLS12381G1_XMD:SHA-256_SSWU_RO_NUL_"

# --- RFC 9380 SSWU parameters ---------------------------------------------
#
# G2 suite BLS12381G2_XMD:SHA-256_SSWU_RO_ (RFC 9380 8.8.2): map to the
# 3-isogenous curve E2': y^2 = x^3 + A2'x + B2' over Fp2, then apply the
# 3-isogeny back to E2.  The isogeny was RE-DERIVED offline with Velu's
# formulas (tools/derive_sswu_g2.py) rather than transcribed: the kernel is
# the unique Fp2-rational order-3 subgroup with j-invariant-0 quotient,
# x-coordinate x0 = -6+6u, and the normalizing isomorphism scale s below is
# the unique 6th root of (4+4u)/B_velu for which the expanded rational map
# reproduces RFC 9380 Appendix E.3 coefficient-for-coefficient (asserted in
# tests/test_h2c_sswu.py).
SSWU_G2_A = (0, 240)          # A' = 240*u
SSWU_G2_B = (1012, 1012)      # B' = 1012*(1+u)
SSWU_G2_Z = (P - 2, P - 1)    # Z  = -(2+u)
ISO3_X0 = (P - 6, 6)          # kernel x-coord: -6 + 6u
ISO3_V = (0, 48)              # Velu v = 2*(3*x0^2 + A')
ISO3_W = (16, 16)             # Velu w = 4*(x0^3 + A'x0 + B') = (2*y0)^2
ISO3_S = (0x8AB05F8BDD54CDE190937E76BC3E447CC27C3D6FBD7063FCD104635A790520C0A395554E5C6AAAA9354FFFFFFFFE38E, 0)

# G1 suite BLS12381G1_XMD:SHA-256_SSWU_RO_ (RFC 9380 8.8.1): map to the
# 11-isogenous curve E1' over Fp, then apply the 11-isogeny back to E1
# (constants of drand_tpu's derivation, RFC 9380 Appendix E.2; the RFC
# J.9.1 vector is pinned in tests/test_torch_g1.py).
SSWU_G1_A = 0x144698A3B8E9433D693A02C96D4982B0EA985383EE66A8D8E8981AEFD881AC98936F8DA0E0F97F5CF428082D584C1D
SSWU_G1_B = 0x12E2908D11688030018B12E8753EEE3B2016C1F0F24F4070A0B9C14FCEF35EF55A23215A316CEAA5D1CC48E98E172BE0
SSWU_G1_Z = 11

# 11-isogeny E1' -> E1 rational map coefficients (ascending powers of x).
ISO1_X_NUM = [
    0x11a05f2b1e833340b809101dd99815856b303e88a2d7005ff2627b56cdb4e2c85610c2d5f2e62d6eaeac1662734649b7,
    0x17294ed3e943ab2f0588bab22147a81c7c17e75b2f6a8417f565e33c70d1e86b4838f2a6f318c356e834eef1b3cb83bb,
    0xd54005db97678ec1d1048c5d10a9a1bce032473295983e56878e501ec68e25c958c3e3d2a09729fe0179f9dac9edcb0,
    0x1778e7166fcc6db74e0609d307e55412d7f5e4656a8dbf25f1b33289f1b330835336e25ce3107193c5b388641d9b6861,
    0xe99726a3199f4436642b4b3e4118e5499db995a1257fb3f086eeb65982fac18985a286f301e77c451154ce9ac8895d9,
    0x1630c3250d7313ff01d1201bf7a74ab5db3cb17dd952799b9ed3ab9097e68f90a0870d2dcae73d19cd13c1c66f652983,
    0xd6ed6553fe44d296a3726c38ae652bfb11586264f0f8ce19008e218f9c86b2a8da25128c1052ecaddd7f225a139ed84,
    0x17b81e7701abdbe2e8743884d1117e53356de5ab275b4db1a682c62ef0f2753339b7c8f8c8f475af9ccb5618e3f0c88e,
    0x80d3cf1f9a78fc47b90b33563be990dc43b756ce79f5574a2c596c928c5d1de4fa295f296b74e956d71986a8497e317,
    0x169b1f8e1bcfa7c42e0c37515d138f22dd2ecb803a0c5c99676314baf4bb1b7fa3190b2edc0327797f241067be390c9e,
    0x10321da079ce07e272d8ec09d2565b0dfa7dccdde6787f96d50af36003b14866f69b771f8c285decca67df3f1605fb7b,
    0x6e08c248e260e70bd1e962381edee3d31d79d7e22c837bc23c0bf1bc24c6b68c24b1b80b64d391fa9c8ba2e8ba2d229,
]
ISO1_X_DEN = [
    0x8ca8d548cff19ae18b2e62f4bd3fa6f01d5ef4ba35b48ba9c9588617fc8ac62b558d681be343df8993cf9fa40d21b1c,
    0x12561a5deb559c4348b4711298e536367041e8ca0cf0800c0126c2588c48bf5713daa8846cb026e9e5c8276ec82b3bff,
    0xb2962fe57a3225e8137e629bff2991f6f89416f5a718cd1fca64e00b11aceacd6a3d0967c94fedcfcc239ba5cb83e19,
    0x3425581a58ae2fec83aafef7c40eb545b08243f16b1655154cca8abc28d6fd04976d5243eecf5c4130de8938dc62cd8,
    0x13a8e162022914a80a6f1d5f43e7a07dffdfc759a12062bb8d6b44e833b306da9bd29ba81f35781d539d395b3532a21e,
    0xe7355f8e4e667b955390f7f0506c6e9395735e9ce9cad4d0a43bcef24b8982f7400d24bc4228f11c02df9a29f6304a5,
    0x772caacf16936190f3e0c63e0596721570f5799af53a1894e2e073062aede9cea73b3538f0de06cec2574496ee84a3a,
    0x14a7ac2a9d64a8b230b3f5b074cf01996e7f63c21bca68a81996e1cdf9822c580fa5b9489d11e2d311f7d99bbdcc5a5e,
    0xa10ecf6ada54f825e920b3dafc7a3cce07f8d1d7161366b74100da67f39883503826692abba43704776ec3a79a1d641,
    0x95fc13ab9e92ad4476d6e3eb3a56680f682b4ee96f7d03776df533978f31c1593174e4b4b7865002d6384d168ecdd0a,
    0x1,
]
ISO1_Y_NUM = [
    0x90d97c81ba24ee0259d1f094980dcfa11ad138e48a869522b52af6c956543d3cd0c7aee9b3ba3c2be9845719707bb33,
    0x134996a104ee5811d51036d776fb46831223e96c254f383d0f906343eb67ad34d6c56711962fa8bfe097e75a2e41c696,
    0xcc786baa966e66f4a384c86a3b49942552e2d658a31ce2c344be4b91400da7d26d521628b00523b8dfe240c72de1f6,
    0x1f86376e8981c217898751ad8746757d42aa7b90eeb791c09e4a3ec03251cf9de405aba9ec61deca6355c77b0e5f4cb,
    0x8cc03fdefe0ff135caf4fe2a21529c4195536fbe3ce50b879833fd221351adc2ee7f8dc099040a841b6daecf2e8fedb,
    0x16603fca40634b6a2211e11db8f0a6a074a7d0d4afadb7bd76505c3d3ad5544e203f6326c95a807299b23ab13633a5f0,
    0x4ab0b9bcfac1bbcb2c977d027796b3ce75bb8ca2be184cb5231413c4d634f3747a87ac2460f415ec961f8855fe9d6f2,
    0x987c8d5333ab86fde9926bd2ca6c674170a05bfe3bdd81ffd038da6c26c842642f64550fedfe935a15e4ca31870fb29,
    0x9fc4018bd96684be88c9e221e4da1bb8f3abd16679dc26c1e8b6e6a1f20cabe69d65201c78607a360370e577bdba587,
    0xe1bba7a1186bdb5223abde7ada14a23c42a0ca7915af6fe06985e7ed1e4d43b9b3f7055dd4eba6f2bafaaebca731c30,
    0x19713e47937cd1be0dfd0b8f1d43fb93cd2fcbcb6caf493fd1183e416389e61031bf3a5cce3fbafce813711ad011c132,
    0x18b46a908f36f6deb918c143fed2edcc523559b8aaf0c2462e6bfe7f911f643249d9cdf41b44d606ce07c8a4d0074d8e,
    0xb182cac101b9399d155096004f53f447aa7b12a3426b08ec02710e807b4633f06c851c1919211f20d4c04f00b971ef8,
    0x245a394ad1eca9b72fc00ae7be315dc757b3b080d4c158013e6632d3c40659cc6cf90ad1c232a6442d9d3f5db980133,
    0x5c129645e44cf1102a159f748c4a3fc5e673d81d7e86568d9ab0f5d396a7ce46ba1049b6579afb7866b1e715475224b,
    0x15e6be4e990f03ce4ea50b3b42df2eb5cb181d8f84965a3957add4fa95af01b2b665027efec01c7704b456be69c8b604,
]
ISO1_Y_DEN = [
    0x16112c4c3a9c98b252181140fad0eae9601a6de578980be6eec3232b5be72e7a07f3688ef60c206d01479253b03663c1,
    0x1962d75c2381201e1a0cbd6c43c348b885c84ff731c4d59ca4a10356f453e01f78a4260763529e3532f6102c2e49a03d,
    0x58df3306640da276faaae7d6e8eb15778c4855551ae7f310c35a5dd279cd2eca6757cd636f96f891e2538b53dbf67f2,
    0x16b7d288798e5395f20d23bf89edb4d1d115c5dbddbcd30e123da489e726af41727364f2c28297ada8d26d98445f5416,
    0xbe0e079545f43e4b00cc912f8228ddcc6d19c9f0f69bbb0542eda0fc9dec916a20b15dc0fd2ededda39142311a5001d,
    0x8d9e5297186db2d9fb266eaac783182b70152c65550d881c5ecd87b6f0f5a6449f38db9dfa9cce202c6477faaf9b7ac,
    0x166007c08a99db2fc3ba8734ace9824b5eecfdfa8d0cf8ef5dd365bc400a0051d5fa9c01a58b1fb93d1a1399126a775c,
    0x16a3ef08be3ea7ea03bcddfabba6ff6ee5a4375efa1f4fd7feb34fd206357132b920f5b00801dee460ee415a15812ed9,
    0x1866c8ed336c61231a1be54fd1d74cc4f9fb0ce4c6af5920abc5750c4bf39b4852cfe2f7bb9248836b233d9d55535d4a,
    0x167a55cda70a6e1cea820597d94a84903216f763e13d87bb5308592e7ea7d4fbc7385ea3d529b35e346ef48bb8913f55,
    0x4d2f259eea405bd48f010a01ad2911d9c6dd039bb61a6290e591b36e636a5c871a5c29f4f83060400f8b49cba8f6aa8,
    0xaccbb67481d033ff5852c1e48c50c477f94ff8aefce42d28c0f9a88cea7913516f968986f7ebbea9684b529e2561092,
    0xad6b9514c767fe3c3613144b45f1496543346d98adf02267d5ceef9a00d9b8693000763e3b90ac11e99b138573345cc,
    0x2660400eb2e4f3b628bdd0d53cd76f2bf565b94e72927c1cb748df27942480e420517bd8714cc80d1fadc1326ed06f7,
    0xe0fa1d816ddc03e6b24255e0d7819c171c40f65e273b853324efcd6356caa205ca2f570f13497804415473a1d634b8f,
    0x1,
]
