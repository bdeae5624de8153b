"""build_s: the program's fit on the corpus (`RDFForest.fit`,
`IVFFlatIndex.fit`), host clock ending in a synchronise."""


def read(ctx):
    return ctx.build_s
