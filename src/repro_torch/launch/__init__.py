"""Launch tooling for the H100: hardware constants (``mesh``), the decode
roofline (``roofline``), the pod-scale Viterbi dry run
(``viterbi_dryrun``), and the LM scaffold's drivers (``serve``,
``train``); port of ``repro.launch`` but its HLO-based tools."""
