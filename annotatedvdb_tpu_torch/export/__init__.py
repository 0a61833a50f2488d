"""Region token layout shared by the serving ``tokenize`` output (the
corpus export that also uses it is not ported yet)."""
