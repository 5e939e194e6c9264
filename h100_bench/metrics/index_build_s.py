"""Host seconds of ``BitmapIndex.build`` (sorting, histograms, column
order, encodings, EWAH)."""


def read(run):
    return run.index_build_s
