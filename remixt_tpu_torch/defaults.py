"""Default configuration parameters of the ``run`` and ``fit`` paths.

A copy of the reference-data names and the algorithm parameters of
``remixt_tpu/defaults.py`` (same names and values, so user YAML configs
carry over). Values are module attributes overlaid by a user config dict
via :mod:`remixt_tpu_torch.config`. The download URLs are the sources
``ref_data.create_ref_data`` fetches with ``wget``. Accelerator knobs of the
JAX package (Pallas switch, compilation cache, device meshes) have no
meaning here and are not copied.
"""

###
# Reference genome and external datasets
###

ensembl_version = '93'
ensembl_genome_version = 'GRCh38'
ensembl_assemblies = [
    'chromosome.' + c for c in
    [str(i) for i in range(1, 23)] + ['X', 'Y', 'MT']
] + ['nonchromosomal']

chromosomes = [str(i) for i in range(1, 23)] + ['X']

chr_name_prefix = ''

ensembl_assembly_url_template = (
    'ftp://ftp.ensembl.org/pub/release-{ensembl_version}/fasta/homo_sapiens/dna/'
    'Homo_sapiens.{ensembl_genome_version}.dna.{ensembl_assembly}.fa.gz')

ucsc_genome_version = 'hg38'

genome_fasta_template = '{ref_data_dir}/Homo_sapiens.{ensembl_genome_version}.{ensembl_version}.dna.chromosomes.fa'
genome_fai_template = '{ref_data_dir}/Homo_sapiens.{ensembl_genome_version}.{ensembl_version}.dna.chromosomes.fa.fai'

gap_url_template = 'http://hgdownload.soe.ucsc.edu/goldenPath/{ucsc_genome_version}/database/gap.txt.gz'
gap_table_template = '{ref_data_dir}/{ucsc_genome_version}_gap.txt.gz'

# Segment length for automatically generated segments
segment_length = int(5e5)

# Length of simulated reads used to calculate mappability
mappability_length = 100

# Mapping quality threshold for filtering mappable reads
map_qual_threshold = 1

# Filter reads marked as duplicate
filter_duplicates = False

# A name ending in .h5 is the JAX package's HDF5 store; any other name a
# directory of per-chromosome start, end and quality .npy files
mappability_template = '{ref_data_dir}/{ucsc_genome_version}.{mappability_length}.bwa.mappability.h5'

# Thousand genomes GRCh38 phased panel
grch38_1kg_chromosomes = ['chr' + str(i) for i in range(1, 23)] + ['chrX']
grch38_1kg_vcf_url_template = (
    'http://ftp.1000genomes.ebi.ac.uk/vol1/ftp/data_collections/1000G_2504_high_coverage/working/'
    '20220422_3202_phased_SNV_INDEL_SV/1kGP_high_coverage_Illumina.{chromosome}.filtered.SNV_INDEL_SV_phased_panel.vcf.gz')
grch38_1kg_X_vcf_url = (
    'http://ftp.1000genomes.ebi.ac.uk/vol1/ftp/data_collections/1000G_2504_high_coverage/working/'
    '20220422_3202_phased_SNV_INDEL_SV/1kGP_high_coverage_Illumina.chrX.filtered.SNV_INDEL_SV_phased_panel.v2.vcf.gz')
grch38_1kg_vcf_filename_template = '{ref_data_dir}/1kGP_high_coverage_Illumina.{chromosome}.filtered.SNV_INDEL_SV_phased_panel.vcf.gz'
grch38_1kg_X_vcf_filename_template = '{ref_data_dir}/1kGP_high_coverage_Illumina.chrX.filtered.SNV_INDEL_SV_phased_panel.vcf.gz'
grch38_1kg_bcf_filename_template = '{ref_data_dir}/1kGP_high_coverage_Illumina.{chromosome}.filtered.SNV_INDEL_SV_phased_panel.bcf'
grch38_1kg_X_bcf_filename_template = '{ref_data_dir}/1kGP_high_coverage_Illumina.chrX.filtered.SNV_INDEL_SV_phased_panel.bcf'
grch38_1kg_phased_chromosome_x = 'chrX'
genetic_maps_grch38_url = 'https://github.com/odelaneau/shapeit4/blob/master/maps/genetic_maps.b38.tar.gz?raw=true'
genetic_map_grch38_filename_template = '{ref_data_dir}/{chromosome}.b38.gmap.gz'

snp_positions_template = '{ref_data_dir}/thousand_genomes_snps.tsv'

# Thousand genomes GRCh37 impute2 panel: the reference of GRCh37 phasing
# through shapeit2, and the source of the read-level simulation's germline
# haplotypes
thousand_genomes_impute_url = 'http://mathgen.stats.ox.ac.uk/impute/ALL_1000G_phase1integrated_v3_impute.tgz'
thousand_genomes_directory = '{ref_data_dir}/ALL_1000G_phase1integrated_v3_impute'
sample_template = thousand_genomes_directory + '/ALL_1000G_phase1integrated_v3.sample'
legend_template = thousand_genomes_directory + '/ALL_1000G_phase1integrated_v3_chr{chromosome}_impute.legend.gz'
haplotypes_template = thousand_genomes_directory + '/ALL_1000G_phase1integrated_v3_chr{chromosome}_impute.hap.gz'
genetic_map_template = thousand_genomes_directory + '/genetic_map_chr{chromosome}_combined_b37.txt'
phased_chromosome_x = 'X_nonPAR'

###
# Algorithm parameters
###

# Maximum inferred fragment length of a read pair classified as concordant
bam_max_fragment_length = 1000

# Maximum soft clipped bases before a read is called discordant
bam_max_soft_clipped = 8

# Check proper pair flag for identifying concordant pairs
bam_check_proper_pair = True

# Heterozygous snp calling
sequencing_base_call_error = 0.01
het_snp_call_threshold = 0.9
homozygous_p_value_threshold = 1e-16

# Shapeit haplotype block resolution
shapeit_num_samples = 100
shapeit_confidence_threshold = 0.95

# Enable correction
do_gc_correction = True
do_mappability_correction = True

# GC bias correction
sample_gc_num_positions = 10000000
gc_position_offset = 4

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

# Fit a multi-sample cohort with one worker thread per local CUDA device,
# each fitting its share of the samples one after another; false fits the
# samples one after another on the first device
use_cohort_sharding = True
