import pytest

# NOTE: do NOT set XLA_FLAGS here — tests must see the real single-device
# CPU platform; only launch/dryrun.py overrides the device count.


@pytest.fixture(scope="session")
def skl_machine():
    from repro.core.isa import TEST_ISA
    from repro.core.simulator import SimMachine
    from repro.core.uarch import SIM_SKL

    return SimMachine(SIM_SKL, TEST_ISA)


@pytest.fixture(scope="session")
def hsw_machine():
    from repro.core.isa import TEST_ISA
    from repro.core.simulator import SimMachine
    from repro.core.uarch import SIM_HSW

    return SimMachine(SIM_HSW, TEST_ISA)


@pytest.fixture(scope="session")
def snb_machine():
    from repro.core.isa import TEST_ISA
    from repro.core.simulator import SimMachine
    from repro.core.uarch import SIM_SNB

    return SimMachine(SIM_SNB, TEST_ISA)


@pytest.fixture(scope="session")
def skl_blocking(skl_machine):
    from repro.core.blocking import find_blocking_instructions
    from repro.core.isa import TEST_ISA

    return find_blocking_instructions(skl_machine, TEST_ISA)


CHAR_SUBSET = [
    "ADD_R64_R64", "XOR_R64_R64", "ADC_R64_R64", "IMUL_R64_R64", "MUL_R64",
    "DIV_R64", "SHLD_R64_R64_I8", "CMC", "TEST_R64_R64", "SETC_R8",
    "CMOVBE_R64_R64", "MOV_R64_M64", "MOV_M64_R64", "ADD_R64_M64",
    "PADDD_X_X", "MULPS_X_X", "MOVQ2DQ_X_X", "AESDEC_X_X", "PSHUFD_X_X",
    "MOV_R64_R64", "MOVSX_R64_R32", "BSWAP_R32", "BSWAP_R64", "POPCNT_R64_R64",
]


@pytest.fixture(scope="session")
def skl_model(skl_machine, skl_blocking):
    from repro.core.characterize import characterize
    from repro.core.isa import TEST_ISA

    return characterize(skl_machine, TEST_ISA, CHAR_SUBSET,
                        blocking=skl_blocking)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "cuda: needs an NVIDIA GPU; skips without one")
