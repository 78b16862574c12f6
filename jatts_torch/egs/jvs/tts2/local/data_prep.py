"""JVS tts2 data preparation (counterpart of egs/jvs/tts2/local/data_prep.py):
the MAS recipes take the tts1 walker's csvs (they read no durations), so
this calls it with the same flags:

    python -m jatts_torch.egs.jvs.tts2.local.data_prep --db-root downloads/jvs_ver1 --outdir data
"""

from jatts_torch.egs.jvs.tts1.local.data_prep import main

if __name__ == "__main__":
    main()
