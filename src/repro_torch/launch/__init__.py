"""Launch tooling for the H100: hardware constants (``mesh``), the decode
roofline (``roofline``) and the pod-scale Viterbi dry run
(``viterbi_dryrun``); port of the Viterbi part of ``repro.launch``."""
