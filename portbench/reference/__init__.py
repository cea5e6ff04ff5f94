"""The benchmark's plain reference: seeded channel traffic and a framed
Viterbi decoder in plain torch. Imports nothing of the decoder under
test."""
