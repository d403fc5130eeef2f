"""Default configuration parameters of the fit.

A copy of the algorithm parameters of ``remixt_tpu/defaults.py`` (same
names and values, so user YAML configs carry over). Values are module
attributes overlaid by a user config dict via :mod:`remixt_tpu_torch.config`.
Accelerator knobs of the JAX package (Pallas switch, compilation cache,
device meshes) have no meaning here and are not copied.
"""

# Male or female for one or two copies of chromosome 'X'
is_female = True

# Maximum copy number in state space for HMM
max_copy_number = 12

# Tumour mixture fractions for initialization of haploid depth optimization
tumour_mix_fractions = [0.45, 0.3, 0.2, 0.1]

# Maximum and minimum ploidy of initial haploid depth parameters
min_ploidy = 1.5
max_ploidy = 6.0

# Force haploid normal and or tumour to specific values
h_normal = None
h_tumour = None

# Maximum proportion of segments with divergent copy number
# for filtering improbable solutions
max_prop_diverge = 0.5

# Model normal contamination
normal_contamination = True

# Minimum length of segments modelled by the likelihood
likelihood_min_segment_length = 10000

# Minimum proportion genotyped reads for segments modelled by the likelihood
likelihood_min_proportion_genotyped = 0.01

# Length scaled weights on divergent segments
divergence_weights = [1e-6, 1e-7, 1e-8]

# Number of iterations of EM for parameter optimization
num_em_iter = 5

# Number of iterations of Variational Inference per EM iteration
num_update_iter = 5

# Disable breakpoints for benchmarking purposes
disable_breakpoints = False

# For debug purposes, disable update of the h parameter
do_h_update = True

# Compute dtype of the inference engine; float64 on the card runs the plain
# chain scan (ops/fb_scan.py) in place of the float32 hand kernels
engine_dtype = 'float32'

# Fit the restart grid in batched chunks rather than one restart at a time
batch_restarts = True

# Restarts advanced together per batched chunk (the wave); every chunk is
# padded to this size
restart_chunk_size = 8

# Try every minor-depth mode with at most this mass fraction strictly below
# it as the normal-depth anchor of the restart grid; 0 anchors the smallest
# mode alone
normal_mode_mass_tolerance = 0.05
