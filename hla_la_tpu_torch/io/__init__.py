from .fasta import read_fasta, write_fasta
from .fastq import read_fastq, write_fastq
