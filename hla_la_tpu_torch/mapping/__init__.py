from .kmer_index import KmerIndex
from .seeder import Seeder, Candidate
