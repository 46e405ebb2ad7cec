"""Algorithmic constants of the reference build that the port uses
(each with the reference header it mirrors), kept here so that the
port reads none of thunder_tpu.constants."""

# --- particle filter (include/Particle.h:52-64) ---
PEAK_FACTOR_MAX = 0.5
PEAK_FACTOR_MIN = 1e-3
PEAK_FACTOR_C = 1 - 1e-2
PEAK_FACTOR_BASE = 2
PERTURB_K_MAX = 1.0

# --- expectation phase loop (include/Optimiser.h:56-67) ---
MIN_N_PHASE_PER_ITER_GLOBAL = 10
MIN_N_PHASE_PER_ITER_LOCAL = 3
MAX_N_PHASE_PER_ITER = 100
N_PHASE_WITH_NO_VARI_DECREASE = 1

# --- reconstructor gridding balance loop (include/Reconstructor.h:61-75) ---
MIN_N_ITER_BALANCE = 10
MAX_N_ITER_BALANCE = 30
DIFF_C_THRES = 1e-2
DIFF_C_DECREASE_THRES = 0.95
N_DIFF_C_NO_DECREASE = 2
WIENER_FACTOR_MIN_R = 5
FSC_BASE_L = 1e-3
FSC_BASE_H = 1 - 1e-3
T_MIN = 1e-25          # floor on T before W iteration (Reconstructor.cpp:1322)
C_ABS_MIN = 1e-6       # floor on |C| in W update (Reconstructor.cpp:1466)

# --- soft edges (include/Macro.h:94-99) ---
EDGE_WIDTH_RL = 6

# --- default gridding kernel parameters (include/Optimiser.h:434-436) ---
DEFAULT_MKB_A = 1.9      # MKB blob radius
DEFAULT_MKB_ALPHA = 15.0 # MKB smoothness

# --- CTF (src/CTF.cpp:18) ---
# electron wavelength [A] = CTF_LAMBDA_A / sqrt(V (1 + V * CTF_LAMBDA_B))
CTF_LAMBDA_A = 12.2643247
CTF_LAMBDA_B = 0.978466e-6

# --- global translations (Optimiser.cpp:661 GSL_MAX_INT(30, ...)) ---
MIN_N_TRANSLATION_GLOBAL = 30
