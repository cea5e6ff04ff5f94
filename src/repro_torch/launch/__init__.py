"""Launch tooling for the H100: hardware constants (``mesh``), the decode
roofline (``roofline``), the pod-scale Viterbi dry run
(``viterbi_dryrun``), the LM scaffold's drivers (``serve``, ``train``,
sharded under torchrun) and its shape-counting dry run (``dryrun``);
port of ``repro.launch`` but its HLO parser (``hlo_cost``)."""
