"""Pinned post-state roots for the generated conformance vectors.

Computed once and committed as constants so the suite detects spec drift
instead of reproducing it: if a handler's behavior changes, its freshly
generated post-state root no longer matches the pinned value and
tests/test_torch_transition_conformance.py fails. The table is the JAX
package's conformance/kat_roots.py table, entry for entry.
This is the external-truth anchor the reference gets from the official
consensus-spec-tests archive (lighthouse/testing/ef_tests,
Makefile:129-135), which is unavailable offline.

If a root changes INTENTIONALLY (a real spec fix), re-pin it and record
why in the commit message.
"""

PINNED_POST_ROOTS = {
    "operations/attestation/altair/valid":
        "62dd1e7934c29f3f8b2b8153a6821b58980d804f189b6943102b265d9084e6aa",
    "operations/attestation/bellatrix/valid":
        "3599663224ab73e1e8514e96a6202e468869e9dae8f8cc2cc96c1a947020adf6",
    "operations/attestation/phase0/valid":
        "9c2b8a3b84ec6f1cbcdbf01ef9f0bbe04cfbd53948659c5d66b3323d98dccb23",
    "operations/attester_slashing/altair/double_vote":
        "0cab68110944b30476cbfc7ee0e6cf070839b9bc683267d2000d2c2825fea0be",
    "operations/attester_slashing/bellatrix/double_vote":
        "6f17d607f9d0cd83ac62b57f60c00dba80ba59f02be95c544aec9c4fad060a96",
    "operations/attester_slashing/phase0/double_vote":
        "b8472c42c85f89d5d5e6ee4e20b2a1974ca0d0703f6d33105a7a63f4b477f9a6",
    "operations/block_header/altair/valid":
        "14d356d4f623cca5a98b5c6d8540ec34748db97880875cd4556afbf379de25e9",
    "operations/block_header/bellatrix/valid":
        "e8fc98e049ebaea1ce3a84802aaa1fd00924546033d347279af8b771f8e27f06",
    "operations/block_header/phase0/valid":
        "369f04db3689f149ce49306a42663452b3b372108ab8983300c1ce6476e7cdd5",
    "operations/deposit/altair/new_validator":
        "8513ed0faca22575677980f9511414726ab57a369a68ddef1370b816b50e7448",
    "operations/deposit/bellatrix/new_validator":
        "3e2e65c84d61acc0b8031ce3e2a5e1fa50ae427a88f1178f91fc9f76acfaf84d",
    "operations/deposit/phase0/new_validator":
        "267d28336245a8d08f2f640afca8c819d3c4033b1ab861d25c15d164b10a0fa8",
    "operations/proposer_slashing/altair/valid":
        "4032ce425594683b1d2ec87b14e56303248b0e42484d62253d874545b9ac6546",
    "operations/proposer_slashing/bellatrix/valid":
        "5a5994451bb71a93d7e06b2310cc428f30de0c3f5545949637310856a93e3690",
    "operations/proposer_slashing/phase0/valid":
        "85a52a406056ac252e9d117f563a0c9c3d6e8211aff9ba4f0700a199a57ce32d",
    "operations/sync_aggregate/altair/empty_valid":
        "63d8a24268fb4ed32367e414c7066633885fe2a21caa39d12050518ff518d9d5",
    "operations/sync_aggregate/bellatrix/empty_valid":
        "fbe906cd18d8584c82b615b0f51b1a3f9d6561bb382ca3c466387756ca44d5cd",
    "operations/voluntary_exit/altair/valid":
        "a57b905634b6c9130ced8077dcc9d45a148ccf73f4afbf0c2d10aa6c90349492",
    "operations/voluntary_exit/bellatrix/valid":
        "a1b25df33c3b6151c03eaf0774433485cdbef08c28acfee8545c6b25925aa097",
    "operations/voluntary_exit/phase0/valid":
        "ef0e90cdb4d9b1f30f24a76ba974e0247e0b451d56085b968edf2b4178b6d237",
    "sanity_blocks/blocks/altair/one_block":
        "2177dff4fe1ba736300ed98bc2d52bb1a7cc3810d3f7331030be7dbc51d283c2",
    "sanity_blocks/blocks/bellatrix/one_block":
        "09e188924dfbed6f9a605e301611a777feb739c1101934439aae23527c81070e",
    "sanity_blocks/blocks/phase0/one_block":
        "ceda39fbc583eb0d42401b66d8abecc654ad9ce37cbd78e264846e1dce0de3c9",
    "sanity_slots/slots/altair/advance_1":
        "cd1d3b7251c506e078cd0038e04320c47ca160b6cb2ec216a18df7a2210688a6",
    "sanity_slots/slots/altair/advance_8":
        "f3ae9b6a1308c14d3bef50ba279e1bd61b025a53b8edb2d09dcac1c05c03fab0",
    "sanity_slots/slots/bellatrix/advance_1":
        "54a7f49bc44a38eef5766e0fbb29bd8203962b04c1ad1ca2daf2f45e5883f2b5",
    "sanity_slots/slots/bellatrix/advance_8":
        "d4aa08db69bad3590c02f38e43e5b5e748b41d3b2188fbd684df586fc3cc04bb",
    "sanity_slots/slots/phase0/advance_1":
        "f975e4e4a3d8fe5fa434cf42fd271546bb46ac98829da3bdc822caf601cd31ac",
    "sanity_slots/slots/phase0/advance_8":
        "c608a0379e5cea1022a04c62e1c1819f91d91a43b477bcbb73dbf41e2d5c3008",
}
